// SHA-256 (FIPS 180-4) + HMAC-SHA256 (RFC 2104) — used to authenticate the
// control plane with a launcher-injected shared secret.
//
// Reference role: horovod/runner/common/util/secret.py generates the job
// secret and common/service/*_service.py HMAC every driver/task message; the
// native controller here verifies an HMAC proof in the HELLO frame so an
// unauthenticated connection cannot join (or poison) the job.
#pragma once

#include <cstdint>
#include <string>

namespace hvdtpu {

// 32-byte binary digest of msg.
void Sha256(const uint8_t* msg, size_t len, uint8_t out[32]);

// Lowercase hex HMAC-SHA256(key, msg).
std::string HmacSha256Hex(const std::string& key, const std::string& msg);

// Constant-time string equality (length leak is fine; contents are not).
bool ConstTimeEquals(const std::string& a, const std::string& b);

}  // namespace hvdtpu

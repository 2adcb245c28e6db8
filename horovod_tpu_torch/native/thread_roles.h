// Thread-role annotations (docs/static-analysis.md "Thread roles").
//
// The TSA layer (common.h) covers every MUTEX; the lock-free subsystems
// (flight recorder, perf/grad slots, shm SPSC rings, the profiler sample
// ring) rely on single-driver contracts instead. These macros turn those
// comments into machine-checked metadata, enforced by
// scripts/check_threadroles.py:
//
//   HVDTPU_CALLED_ON(role)  — this function may only be called by threads
//                             running as `role`. Roles: background (the
//                             core's collective-driving loop, including the
//                             Python host thread strictly before the loop
//                             starts), user (Python caller threads), signal
//                             (async-signal handlers), any (thread-safe).
//   HVDTPU_ROLE(role)       — this function IS a role's entry point (thread
//                             loop or signal handler): its body executes as
//                             `role`, seeding the checker's call-graph walk.
//
// The checker rejects calls from role A into functions pinned to role B,
// requires every public method of the lock-free subsystem headers to declare
// a role, and forbids anything reachable from a `signal` root from touching
// malloc/locks/stdio (the flight recorder's fatal-handler contract). Under
// clang both expand to annotate attributes so `-ast-dump=json` carries them;
// under gcc they compile to nothing.
//
// Kept in its own header (not common.h) so the dependency-light headers —
// transport.h, shm_transport.h, flightrec.h, perfstats.h, gradstats.h,
// tracing.h — can annotate without pulling in common.h's <thread>/<mutex>
// transitive weight.
#pragma once

#if defined(__clang__)
#define HVDTPU_CALLED_ON(role) \
  __attribute__((annotate("hvdtpu_called_on:" #role)))
#define HVDTPU_ROLE(role) __attribute__((annotate("hvdtpu_role:" #role)))
#else
#define HVDTPU_CALLED_ON(role)  // no-op under gcc; checked by lint
#define HVDTPU_ROLE(role)       // no-op under gcc; checked by lint
#endif

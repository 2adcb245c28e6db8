"""An HTTP key-value store with HMAC-signed requests: the elastic
rendezvous and the launcher's transport (counterpart of
``horovod_tpu/runner/http_kv.py``: ``_sign`` :23, ``KVStoreServer`` :85,
``KVStoreClient`` :130; reference: ``horovod/runner/http/http_server.py``
``KVStoreHandler`` :35, ``RendezvousServer`` :112).

The wire is the JAX package's: GET, PUT and DELETE of byte values at a
path, and, when the server has a secret, the header ``X-Hvdtpu-Auth``
holding the hex HMAC-SHA256 of ``method\\npath\\nbody`` under the secret;
a request without a valid proof gets 403, a missing key 404. So either
package's client talks to either package's server.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

_AUTH_HEADER = "X-Hvdtpu-Auth"
# The store is reached directly, never through a proxy named by the
# environment.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _sign(secret: str, method: str, path: str, body: bytes) -> str:
    """The request's proof (reference: ``secret.py`` and the HMAC'd
    messages of ``common/service/driver_service.py``)."""
    msg = method.encode() + b"\n" + path.encode() + b"\n" + body
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"

    def log_message(self, fmt, *args):
        pass

    def _authorized(self, body: bytes = b"") -> bool:
        secret = self.server.secret
        if not secret:
            return True
        proof = self.headers.get(_AUTH_HEADER, "")
        if hmac.compare_digest(proof, _sign(secret, self.command, self.path,
                                            body)):
            return True
        self.send_response(403)
        self.end_headers()
        return False

    def do_GET(self):
        if not self._authorized():
            return
        with self.server.lock:
            val = self.server.store.get(self.path)
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self._authorized(body):
            return
        with self.server.lock:
            self.server.store[self.path] = body
        if self.server.put_hook is not None:
            self.server.put_hook(self.path, body)
        self.send_response(200)
        self.end_headers()

    def do_DELETE(self):
        if not self._authorized():
            return
        with self.server.lock:
            self.server.store.pop(self.path, None)
        self.send_response(200)
        self.end_headers()


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, port: int, secret: Optional[str],
                 put_hook: Optional[Callable[[str, bytes], None]]):
        super().__init__(("0.0.0.0", port), _Handler)
        self.store: Dict[str, bytes] = {}
        self.lock = threading.Lock()
        self.secret = secret
        self.put_hook = put_hook


class KVStoreServer:
    """The threaded store. ``put_hook(path, value)`` runs on every PUT
    (the reference collects worker addresses that way,
    ``elastic/rendezvous.py:52``). ``put``/``get``/``keys`` are the
    driver's own access, in its process."""

    def __init__(self, port: int = 0, put_hook=None,
                 secret: Optional[str] = None):
        self._server = _Server(port, secret, put_hook)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def put(self, key: str, value: bytes) -> None:
        with self._server.lock:
            self._server.store[key] = value

    def get(self, key: str) -> Optional[bytes]:
        with self._server.lock:
            return self._server.store.get(key)

    def keys(self, prefix: str = "") -> List[str]:
        with self._server.lock:
            return [k for k in self._server.store if k.startswith(prefix)]


class KVStoreClient:
    """A client of the store; with ``secret``, every request carries its
    proof."""

    def __init__(self, addr: str, port: int, timeout: float = 10.0,
                 secret: Optional[str] = None):
        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._secret = secret

    def _request(self, method: str, key: str,
                 body: Optional[bytes] = None) -> bytes:
        headers = {}
        if self._secret:
            headers[_AUTH_HEADER] = _sign(self._secret, method, key,
                                          body or b"")
        req = urllib.request.Request(self._base + key, data=body,
                                     method=method, headers=headers)
        with _OPENER.open(req, timeout=self._timeout) as resp:
            return resp.read()

    def put(self, key: str, value: bytes) -> None:
        self._request("PUT", key, value)

    def get(self, key: str) -> Optional[bytes]:
        """The value, or None when the key is absent."""
        try:
            return self._request("GET", key)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

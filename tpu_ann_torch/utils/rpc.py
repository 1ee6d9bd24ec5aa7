"""Minimal RPC substrate for distributed serving — a copy of
`tpu_ann/utils/rpc.py`, the role of the reference's ``contrib/rpc.py``
(pickle/TCP ``FileSock`` streams with a ``RestrictedUnpickler``,
rpc.py:26-258).

Every message is a single length-prefixed frame (8-byte big-endian size +
pickle payload), the same frames as the JAX package's, so a client of
either package talks to a server of the other. Framing makes message
boundaries explicit, so a partial read can never desynchronise the
stream.

The unpickler only resolves names from an allowlist (numpy
reconstruction helpers + scalar builtins), so a malicious peer cannot
instantiate arbitrary classes (rpc.py:35-44
``RestrictedUnpickler.find_class``). torch is not on it: a server hands
back numpy arrays.

The server is threaded: one daemon thread per accepted connection, each
running a request loop (call frames in, result/exception frames out) —
the role of ``rpc.Server.exec_loop`` (rpc.py:160-186). Handlers that use
the GPU share the one CUDA context of the process; batching queries
across clients is the caller's job.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Callable, Optional

_HDR = struct.Struct(">Q")
# refuse frames above 4 GiB — a corrupt header would otherwise trigger an
# absurd allocation before the read fails
_MAX_FRAME = 4 << 30

_SAFE_BUILTINS = {
    "complex", "frozenset", "set", "slice", "range", "bytearray",
    "bool", "int", "float", "str", "bytes", "tuple", "list", "dict",
}


class RestrictedUnpickler(pickle.Unpickler):
    """Allowlist unpickler (= rpc.py:35 ``RestrictedUnpickler``): numpy
    array reconstruction + scalar builtins only."""

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"rpc: refusing to unpickle {module}.{name}")


def _loads(buf: bytes) -> Any:
    return RestrictedUnpickler(io.BytesIO(buf)).load()


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _HDR.size)
    (size,) = _HDR.unpack(hdr)
    if size > _MAX_FRAME:
        raise ConnectionError(f"rpc: oversized frame ({size} bytes)")
    return _loads(_recv_exact(sock, size))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("rpc: peer closed mid-frame")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


class ServerException(Exception):
    """Remote call raised; carries the remote traceback text."""


class Server:
    """Exposes an object's public methods over TCP.

    Wire protocol: client sends ``(method_name, args_tuple, kwargs_dict)``
    frames; server replies ``("ok", result)`` or ``("err", repr, tb)``.
    A ``("ok", None)`` reply to the reserved name ``"__close__"`` ends the
    connection. Equivalent of rpc.py:94-186 (Server.one_function /
    exec_loop), with explicit status tags instead of pickled exception
    objects (exceptions never round-trip through the restricted
    unpickler).
    """

    def __init__(self, handler: Any, port: int = 0, host: str = "",
                 v6: bool = False):
        self.handler = handler
        fam = socket.AF_INET6 if v6 else socket.AF_INET
        self._lsock = socket.socket(fam, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(16)
        self.port = self._lsock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self) -> None:
        """Accept loop; returns after :meth:`shutdown`."""
        self._lsock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._lsock.close()

    def serve_in_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self._stop.set()

    # -- per-connection request loop --------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    name, args, kwargs = recv_frame(conn)
                except (ConnectionError, OSError, EOFError):
                    return
                if name == "__close__":
                    try:
                        send_frame(conn, ("ok", None))
                    except OSError:
                        pass
                    return
                try:
                    if name.startswith("_"):
                        raise AttributeError(
                            f"rpc: private method {name!r} not callable")
                    fn = getattr(self.handler, name)
                    result = fn(*args, **kwargs)
                    reply = ("ok", result)
                except Exception as e:  # noqa: BLE001 - forwarded to client
                    reply = ("err", repr(e), traceback.format_exc())
                try:
                    send_frame(conn, reply)
                except OSError:
                    return


class Client:
    """Proxy whose attribute calls execute on the server
    (= rpc.py:199-227 ``Client.generic_fun`` / ``__getattr__``)."""

    def __init__(self, host: str, port: int, v6: bool = False):
        fam = socket.AF_INET6 if v6 else socket.AF_INET
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def call(self, name: str, *args, **kwargs) -> Any:
        with self._lock:  # one in-flight call per connection
            send_frame(self._sock, (name, args, kwargs))
            reply = recv_frame(self._sock)
        if reply[0] == "ok":
            return reply[1]
        raise ServerException(f"{reply[1]}\n--- remote traceback ---\n"
                              f"{reply[2]}")

    def close(self) -> None:
        try:
            with self._lock:
                send_frame(self._sock, ("__close__", (), {}))
                recv_frame(self._sock)
        except (OSError, ConnectionError):
            pass
        self._sock.close()

    def __getattr__(self, name: str) -> Callable[..., Any]:
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **kw: self.call(name, *a, **kw)


def run_server(new_handler: Callable[[], Any], port: int = 0,
               v6: bool = False,
               ready: Optional[threading.Event] = None,
               port_out: Optional[list] = None) -> None:
    """Build a handler and serve it forever (= rpc.py:229 ``run_server``).

    ``port_out``/``ready`` let a launcher learn the bound port when using
    an ephemeral one (port=0) — the reference prints it to a report file
    instead (rpc.py:232-241).
    """
    srv = Server(new_handler(), port=port, v6=v6)
    if port_out is not None:
        port_out.append(srv.port)
    if ready is not None:
        ready.set()
    srv.serve_forever()

"""The framed JSON wire of namazu's sidecar: the port's own copy of the
codec in ``namazu_tpu/endpoint/agent.py`` and a keep-alive server, the
counterpart of ``namazu_tpu/endpoint/framed.py``'s ``FramedServer``.

A frame is a 4-byte little-endian length followed by that many bytes of
UTF-8 JSON. The high bit of the length marks a frame in the binary codec,
which this wire does not speak: such a frame is read and answered
``{"ok": false}`` in JSON, as is a frame whose body is not a JSON
object, so the client's stream stays in sync. A connection carries any
number of request/response pairs, served in order; EOF, a socket error
or an oversized frame drops it. The server reports each answered
request's bytes, in and out, by op to its telemetry sink
(``wire_bytes``), as the reference's server does. A request that carries
a causality stamp (``ctx``) has it merged into the sink's clock, and its
answer gets a fresh stamp unless the handler set one; with a sink that
stamps nothing (the default) the answer's bytes are as without stamps.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from typing import Callable, Optional, Tuple

from namazu_tpu_torch.obs import NULL, Telemetry

log = logging.getLogger("namazu_tpu_torch.wire")

MAX_FRAME = 16 * 1024 * 1024
BINARY_FRAME_FLAG = 0x80000000

#: handler(request dict) -> response dict
Handler = Callable[[dict], dict]


class FrameError(ValueError):
    """The framing layer itself is broken (an oversized length)."""


def write_frame(sock: socket.socket, payload: dict) -> int:
    """Write one JSON frame; returns the body's byte count."""
    data = json.dumps(payload).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)
    return len(data)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def read_frame_raw(sock: socket.socket):
    """One frame as ``(binary?, body bytes)``; None on EOF. Raises
    :class:`FrameError` for a length past MAX_FRAME."""
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack("<I", header)
    binary = bool(length & BINARY_FRAME_FLAG)
    length &= ~BINARY_FRAME_FLAG
    if length > MAX_FRAME:
        raise FrameError(f"frame too large: {length}")
    body = _read_exact(sock, length)
    if body is None:
        return None
    return binary, body


def read_frame(sock: socket.socket) -> Optional[dict]:
    """One JSON frame decoded; None on EOF."""
    frame = read_frame_raw(sock)
    if frame is None:
        return None
    binary, body = frame
    if binary:
        raise FrameError("binary frames are not supported by this wire")
    return json.loads(body)


def answer(handler: Handler, binary: bool, body: bytes,
           telemetry: Telemetry = NULL) -> Tuple[Optional[str], dict]:
    """``(op, response)`` for one raw frame: the request's op (``"frame"``
    when it names none) and the handler's response, or ``None`` and
    ``ok: false`` for a frame the wire cannot take; a handler that
    raised is answered ``ok: false`` too. A request's ``ctx`` stamp is
    merged into ``telemetry``'s clock before the handler runs, and the
    response of such a request gets ``telemetry``'s fresh stamp (the
    reference's ``FramedServer._answer``)."""
    if binary:
        return None, {"ok": False, "error": "binary frames are not "
                                            "supported; use the JSON codec"}
    try:
        req = json.loads(body)
    except ValueError as e:
        return None, {"ok": False, "error": f"undecodable json frame: {e}"}
    if not isinstance(req, dict):
        return None, {"ok": False, "error": "frame must be a JSON object"}
    op = str(req.get("op") or "frame")
    ctx = req.get("ctx")
    if ctx is not None:
        telemetry.observe_wire(ctx)
    try:
        resp = handler(req)
    except Exception as e:  # answer, never desync the wire
        log.exception("op %r failed", req.get("op"))
        resp = {"ok": False, "error": repr(e)}
    if ctx is not None:
        stamp = telemetry.wire_stamp()
        if stamp is not None:
            resp.setdefault("ctx", stamp)
    return op, resp


class FramedServer:
    """Keep-alive framed-JSON TCP server: one thread per connection, the
    connection's requests answered in order."""

    def __init__(self, handler: Handler, name: str = "framed",
                 telemetry: Telemetry = NULL):
        self._handler = handler
        self._name = name
        self._telemetry = telemetry
        self._sock: Optional[socket.socket] = None
        self._conns: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []

    def bind_tcp(self, host: str, port: int, backlog: int = 8) -> int:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(backlog)
        self._sock = srv
        return self.port

    @property
    def port(self) -> int:
        assert self._sock is not None, "bind before asking the port"
        return self._sock.getsockname()[1]

    def start(self) -> None:
        assert self._sock is not None, "bind before start"
        t = threading.Thread(target=self._accept_loop,
                             name=f"{self._name}-accept", daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        srv = self._sock
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return  # closed by shutdown()
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name=f"{self._name}-conn", daemon=True)
            t.start()
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    frame = read_frame_raw(conn)
                except FrameError as e:
                    log.warning("%s: dropping connection: %s", self._name, e)
                    return
                if frame is None:
                    return
                op, resp = answer(self._handler, *frame,
                                  telemetry=self._telemetry)
                try:
                    n_out = write_frame(conn, resp)
                except OSError:
                    return
                if op is not None:
                    self._telemetry.wire_bytes("json", op,
                                               len(frame[1]) + n_out)
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop accepting, sever live connections, join every thread."""
        self._stop.set()
        srv, self._sock = self._sock, None
        if srv is not None:
            try:
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            srv.close()
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(timeout)


def request(addr: str, req: dict, timeout: float = 300.0) -> dict:
    """One framed request/response on a fresh connection to ``host:port``."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host or "127.0.0.1", int(port)),
                                  timeout=timeout) as s:
        write_frame(s, req)
        resp = read_frame(s)
    if resp is None:
        raise ConnectionError(f"{addr}: connection closed")
    return resp

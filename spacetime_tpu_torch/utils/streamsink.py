"""Live MJPEG-over-HTTP view (counterpart of
`spacetime_tpu/utils/streamsink.py`, with its contract).

`GET /` is a page showing `GET /stream` (multipart/x-mixed-replace JPEG
parts); `GET /key?d=<0|1>&k=<name>[&t=<token>]` posts a key event, which
`poll_keys` drains for the Engine (`Engine.run(key_source=...)`).  A
non-loopback bind requires a `key_token` on /key and generates one unless
`key_token=""` opts out.  The native path binds `native/streamsink.cpp`
(JPEG encoding with libjpeg and client IO on native threads), built by
utils/native.py; where that build fails, a ThreadingHTTPServer of this
module serves JPEGs that an encoder thread makes with utils/jpeg.py (numpy,
no pillow).  Either way `submit` leaves the frame in a latest-wins slot
and returns: a slow client or encoder skips frames and never holds the
Engine back.  `native` says which path a sink took.
"""

from __future__ import annotations

import ctypes
import secrets
import socket
import threading
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from . import jpeg, native
from .framesink import to_u8

BOUNDARY = b"spacetimeframe"
INDEX_PAGE = (b"<!doctype html><html><body style='margin:0;background:#111'>"
              b"<img src='/stream'></body></html>")


def _load():
    lib = native.load("streamsink.cpp", ("-ljpeg",))
    if lib is not None:
        lib.ss_create.restype = ctypes.c_void_p
        lib.ss_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
        lib.ss_port.restype = ctypes.c_int
        lib.ss_port.argtypes = [ctypes.c_void_p]
        lib.ss_submit.restype = ctypes.c_int
        lib.ss_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ss_clients.restype = ctypes.c_long
        lib.ss_clients.argtypes = [ctypes.c_void_p]
        lib.ss_frames.restype = ctypes.c_long
        lib.ss_frames.argtypes = [ctypes.c_void_p]
        lib.ss_poll_keys.restype = ctypes.c_int
        lib.ss_poll_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.ss_set_key_token.restype = None
        lib.ss_set_key_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ss_close.restype = None
        lib.ss_close.argtypes = [ctypes.c_void_p]
    return lib


class _PyMjpegServer:
    """The Python path: a ThreadingHTTPServer streaming utils/jpeg.py's
    JPEGs.  As in the native server, `submit` only leaves the frame in a
    latest-wins slot; an encoder thread encodes the newest one."""

    def __init__(self, port: int, quality: int, bind: str, key_token: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._key_token = key_token
        self._quality = quality
        self._cond = threading.Condition()
        self._raw = None  # the newest submitted frame, not yet encoded
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._closed = False
        self.frames = 0
        self._keys_mu = threading.Lock()
        self._keys: list = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/key?"):
                    outer._key(self)
                elif self.path.startswith("/stream"):
                    outer._stream(self)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(INDEX_PAGE)))
                    self.end_headers()
                    self.wfile.write(INDEX_PAGE)

        self._srv = ThreadingHTTPServer((bind, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_port
        self._threads = [threading.Thread(target=self._srv.serve_forever, daemon=True,
                                          name="streamsink"),
                         threading.Thread(target=self._encode_loop, daemon=True,
                                          name="streamsink-encoder")]
        for t in self._threads:
            t.start()

    def _encode_loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._raw is not None or self._closed)
                if self._closed:
                    return
                arr, self._raw = self._raw, None
            data = jpeg.encode_jpeg(arr, self._quality)
            with self._cond:
                self._jpeg = data
                self._seq += 1
                self.frames += 1
                self._cond.notify_all()

    def _key(self, req) -> None:
        q = parse_qs(urlsplit(req.path).query)
        if self._key_token and (q.get("t") or [""])[0] != self._key_token:
            req.send_response(403)
            req.end_headers()
            return
        name = (q.get("k") or [""])[0]
        down = (q.get("d") or ["1"])[0] != "0"
        if name and len(name) <= 32 and "\n" not in name:
            with self._keys_mu:
                if len(self._keys) < 256:
                    self._keys.append((name, down))
        req.send_response(204)
        req.end_headers()

    def _stream(self, req) -> None:
        req.send_response(200)
        req.send_header("Content-Type",
                        f"multipart/x-mixed-replace; boundary={BOUNDARY.decode()}")
        req.end_headers()
        last = 0
        try:
            while True:
                with self._cond:
                    self._cond.wait_for(lambda: self._seq != last or self._closed, timeout=1.0)
                    if self._closed:
                        return
                    if self._seq == last or self._jpeg is None:
                        continue
                    frame, last = self._jpeg, self._seq
                req.wfile.write(b"--" + BOUNDARY + b"\r\nContent-Type: image/jpeg\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(frame))
                req.wfile.write(frame)
                req.wfile.write(b"\r\n")
        except (BrokenPipeError, ConnectionResetError):
            return

    def submit(self, arr) -> None:
        arr = arr.copy()  # the caller may reuse its array
        with self._cond:
            self._raw = arr
            self._cond.notify_all()

    def poll_keys(self) -> list:
        with self._keys_mu:
            out, self._keys = self._keys, []
        return out

    def close(self) -> None:
        with self._cond:
            self._closed = True  # ends every /stream loop
            self._cond.notify_all()
        self._srv.shutdown()
        self._srv.server_close()
        for t in self._threads:
            t.join()


class StreamSink:
    """Live MJPEG-over-HTTP view: submit (H, W, 3) float [0, 1] or uint8
    frames; browse to http://host:port/ to watch."""

    def __init__(self, port: int, width: int, height: int, quality: int = 85,
                 bind: str = "127.0.0.1", key_token: Optional[str] = None):
        """`bind` defaults to loopback: exposing the stream to the network is
        opt-in (bind='0.0.0.0').  `key_token` is the shared secret gating
        /key (which steers, and through 'q' can end, the Engine): on a
        non-loopback bind one is generated unless key_token='' opts out;
        browse to http://host:port/?t=<token>."""
        # a literal IPv4 address up front: the native server falls back to
        # loopback where inet_pton fails (hostnames, IPv6), which would serve
        # elsewhere than the CLI prints; an unresolvable bind raises here
        try:
            socket.inet_aton(bind)
        except OSError:
            bind = socket.gethostbyname(bind)
        if key_token is None:
            key_token = "" if bind.startswith("127.") else secrets.token_urlsafe(12)
        self.bind = bind
        self.key_token = key_token
        self.width, self.height = width, height
        self._lib = _load()
        self._handle = None
        self._py: Optional[_PyMjpegServer] = None
        if self._lib is not None:
            self._handle = self._lib.ss_create(bind.encode(), port, width, height, quality)
            if self._handle is not None and key_token:
                self._lib.ss_set_key_token(self._handle, key_token.encode())
        if self._handle is None:
            self._py = _PyMjpegServer(port, quality, bind, key_token)

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def port(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_port(self._handle))
        return self._py.port

    @property
    def frames_encoded(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_frames(self._handle))
        return self._py.frames

    @property
    def clients(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_clients(self._handle))
        return -1  # not tracked by the Python path

    def submit(self, frame) -> None:
        arr = to_u8(frame, self.width, self.height)
        if self._handle is not None:
            self._lib.ss_submit(self._handle, arr.ctypes.data)  # copied into its slot
        else:
            self._py.submit(arr)

    def poll_keys(self) -> list:
        """Drain the key events posted by clients (GET /key?d=&k=) as
        [(key_name, down), ...] in arrival order."""
        if self._handle is not None:
            buf = ctypes.create_string_buffer(16384)
            n = self._lib.ss_poll_keys(self._handle, buf, len(buf))
            out = []
            for line in buf.raw[:n].decode("utf-8", "replace").splitlines():
                if len(line) >= 3 and line[1] == " ":
                    out.append((line[2:], line[0] != "0"))
            return out
        return self._py.poll_keys()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ss_close(self._handle)
            self._handle = None
        if self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

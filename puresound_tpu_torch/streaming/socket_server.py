"""TCP serving front-end over :class:`SessionServer` (counterpart of
puresound_tpu/streaming/socket_server.py; the same wire protocol, byte for
byte, so JAX's `StreamingClient` talks to this server and this one to
JAX's).

One TCP connection per session, attached to a free batch slot of a
running `SessionServer`. Every per-connection step is host-side ring I/O
through the C++ hub, so the connection threads never touch the device: the
serving thread alone runs one fixed-shape step per tick.

Wire protocol (little-endian, length-prefixed)
----------------------------------------------
Every message is an 8-byte header ``struct('<II')`` = ``(type,
payload_bytes)`` followed by the raw payload.

===========  ====  ==========================================================
message      type  payload
===========  ====  ==========================================================
HELLO        1     float32 array. Empty for NS sessions; ``embed_dim``
                   values = a precomputed d-vector; any other length = an
                   enrollment waveform (requires the server's ``embed_fn``).
ACK          2     ``struct('<III')`` = (slot_id, chunk_samples, n_sources).
AUDIO        3     float32 PCM samples, client -> server. Any length; the
                   hub buffers to chunk boundaries.
AUDIO_OUT    4     float32 enhanced PCM, server -> client. For SIMO
                   separation (n_sources > 1) the M separated sources are
                   sample-interleaved: sample s of source m sits at flat
                   index ``s * M + m``.
BYE          5     empty. Client -> server ends the session; the server
                   drains every completed chunk's output, replies BYE, and
                   frees the slot. Dropping the connection without BYE
                   detaches immediately (no drain).
ERROR        6     utf-8 message; the server closes after sending.
===========  ====  ==========================================================

Sample-count contract: after BYE the client has received exactly
``(samples_sent // chunk_samples) * chunk_samples`` samples — the trailing
partial chunk stays unprocessed, mirroring real-time semantics where a
stream that stops mid-chunk never completes its last tick. If the client
lets its output ring overflow (sending a long stream without ever reading
AUDIO_OUT), the dropped samples can never be delivered: the server then
replies ERROR (with the dropped count) instead of BYE, so the shortfall is
loud rather than silent.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["SocketServingFront", "StreamingClient",
           "MSG_HELLO", "MSG_ACK", "MSG_AUDIO", "MSG_AUDIO_OUT",
           "MSG_BYE", "MSG_ERROR"]

MSG_HELLO = 1
MSG_ACK = 2
MSG_AUDIO = 3
MSG_AUDIO_OUT = 4
MSG_BYE = 5
MSG_ERROR = 6

_HDR = struct.Struct("<II")

# hard cap on a single message payload (64 MiB ≈ 17 min of f32 16 kHz
# audio): a corrupt/malicious length header must not make the server
# allocate gigabytes. Clients chunk larger sends.
MAX_PAYLOAD = 64 << 20


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF.

    ``deadline`` (a ``time.monotonic()`` instant) bounds the WHOLE read, not
    each recv: a per-recv timeout alone lets a byte-trickling client hold
    the reader thread forever (one byte per timeout window never expires).
    """
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("recv deadline exceeded")
            sock.settimeout(remaining)
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("peer closed")
        got += k
    return bytes(buf)


def _recv_msg(sock: socket.socket,
              deadline: Optional[float] = None) -> Tuple[int, bytes]:
    t, n = _HDR.unpack(_recv_exact(sock, _HDR.size, deadline))
    if n > MAX_PAYLOAD:
        raise ConnectionError(f"oversized payload ({n} bytes)")
    return t, (_recv_exact(sock, n, deadline) if n else b"")


def _send_msg(sock: socket.socket, t: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(t, len(payload)) + payload)


class SocketServingFront:
    """Listen on a TCP port and map each connection to a serving slot.

    Args:
        server: a constructed :class:`SessionServer`. Its tick loop is
            started by :meth:`start` if not already running (and stopped by
            :meth:`stop` only if this front started it).
        host/port: bind address; ``port=0`` picks a free port (read it back
            from :attr:`address` — the test/demo pattern).
        poll_s: output-pump poll interval per connection.
        drain_timeout_s: max wait after BYE for the serving loop to finish
            the session's completed chunks before giving up and closing.
        hello_timeout_s: a fresh connection must send HELLO within this
            window or it is dropped (it holds no serving slot, but idle
            reader threads aren't free either).
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.001, drain_timeout_s: float = 30.0,
                 n_sources: int = 1, hello_timeout_s: float = 30.0):
        self.server = server
        self.poll_s = poll_s
        self.drain_timeout_s = drain_timeout_s
        self.hello_timeout_s = hello_timeout_s
        self.n_sources = n_sources
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        # accept() blocked on a closed listener is not reliably woken on
        # all platforms — poll with a short timeout so stop() always works
        self._sock.settimeout(0.25)
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: list = []
        self._live_conns: set = set()
        self._conn_lock = threading.Lock()
        self._started_server = False

    @property
    def address(self) -> Tuple[str, int]:
        return self._sock.getsockname()[:2]

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if getattr(self.server, "_thread", None) is None:
            self.server.start()
            self._started_server = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join()
            self._accept_thread = None
        with self._conn_lock:
            for c in list(self._live_conns):  # unblock silent clients
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        for t in self._conn_threads:
            t.join(timeout=5.0)
        self._conn_threads.clear()
        if self._started_server:
            self.server.stop()
            self._started_server = False

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:  # listener closed by stop()
                return
            if self._stop.is_set():
                conn.close()
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._conn_threads = [x for x in self._conn_threads
                                  if x.is_alive()]  # prune finished
            self._conn_threads.append(t)

    # ----------------------------------------------------------- connection
    def _attach_from_hello(self, payload: bytes) -> int:
        srv = self.server
        if getattr(srv, "_dvec", None) is None:
            return srv.attach()
        vec = np.frombuffer(payload, np.float32)
        if vec.size == 0:
            raise ValueError("TSE serving needs a HELLO payload "
                             "(d-vector or enrollment waveform)")
        if vec.size == srv._dvec.shape[1]:
            return srv.attach(dvec=vec)
        return srv.attach(enroll=vec)

    def _handle(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            self._live_conns.add(conn)
        sid = None
        hub = self.server.hub
        chunk = self.server.chunk
        out_sent = [0]  # shared with the pump thread
        pump_stop = threading.Event()
        send_lock = threading.Lock()

        # cap each message at the protocol's payload limit: the output
        # ring can coalesce many ticks (slow poll, burst push) and the
        # receive side rejects oversized frames; keep the split aligned
        # to the SIMO interleave frame (module MAX_PAYLOAD read at pump
        # start so tests can shrink it deterministically per-connection)
        def _payload_cap():
            return max(self.n_sources,
                       (MAX_PAYLOAD // 4) // self.n_sources
                       * self.n_sources)

        def pump():
            cap = _payload_cap()
            while not pump_stop.is_set():
                n = hub.output_available(sid)
                if n:
                    n = min(n, cap)
                    out = hub.pop_output(sid, n)
                    try:
                        with send_lock:
                            _send_msg(conn, MSG_AUDIO_OUT, out.tobytes())
                    except OSError:
                        return  # client vanished; reader thread cleans up
                    out_sent[0] += len(out)
                else:
                    time.sleep(self.poll_s)

        pump_thread = None
        clean_bye = False
        try:
            # a connection that never sends a COMPLETE HELLO must not pin
            # this reader thread (it holds no slot yet, but threads aren't
            # free) — a hard deadline on the whole message, so trickled
            # bytes can't keep resetting the clock
            t, payload = _recv_msg(
                conn, deadline=time.monotonic() + self.hello_timeout_s)
            conn.settimeout(None)
            if t != MSG_HELLO:
                _send_msg(conn, MSG_ERROR, b"expected HELLO")
                return
            try:
                sid = self._attach_from_hello(payload)
            except (RuntimeError, ValueError) as e:
                _send_msg(conn, MSG_ERROR, str(e).encode())
                return
            with send_lock:
                _send_msg(conn, MSG_ACK,
                          struct.pack("<III", sid, chunk, self.n_sources))
            pump_thread = threading.Thread(target=pump, daemon=True)
            pump_thread.start()

            pushed = 0
            while True:
                t, payload = _recv_msg(conn)
                if t == MSG_BYE:
                    clean_bye = True
                    break
                if t != MSG_AUDIO:
                    with send_lock:
                        _send_msg(conn, MSG_ERROR,
                                  f"unexpected message type {t}".encode())
                    return
                if len(payload) % 4:
                    with send_lock:
                        _send_msg(conn, MSG_ERROR,
                                  b"AUDIO payload is not float32-aligned")
                    return
                arr = np.frombuffer(payload, np.float32)
                while arr.size:  # ring backpressure: push truncates on full
                    n = hub.push_input(sid, arr)
                    pushed += n
                    arr = arr[n:]
                    if arr.size:
                        if (self._stop.is_set()
                                or self.server.failure is not None):
                            return  # nothing will ever drain this ring
                        time.sleep(self.poll_s)

            # BYE drain: every completed chunk's output must reach the
            # client — minus samples hub_scatter had to DROP because the
            # client let its output ring overflow (those can never arrive)
            expected = (pushed // chunk) * chunk * self.n_sources
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                dropped = hub.output_dropped(sid)
                if out_sent[0] >= expected - dropped:
                    break
                if pump_thread is not None and not pump_thread.is_alive():
                    break  # client's receive side died: nothing more can
                    # be delivered — free the slot now, don't sit out the
                    # whole drain timeout
                if self.server.failure is not None:
                    break  # serving loop died; no more output is coming
                time.sleep(self.poll_s)
            dropped = hub.output_dropped(sid)
            if dropped:
                clean_bye = False  # the sample-count contract was violated
                with send_lock:
                    _send_msg(conn, MSG_ERROR,
                              (f"output overflow: {dropped} samples dropped "
                               "(client did not drain AUDIO_OUT)").encode())
        except (ConnectionError, OSError):
            pass  # client vanished: fall through to cleanup
        finally:
            pump_stop.set()
            if pump_thread is not None:
                pump_thread.join(timeout=1.0)
                if pump_thread.is_alive():
                    # pump stuck in sendall to a peer that stopped reading:
                    # sever the socket so the slot is freed regardless
                    clean_bye = False
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    pump_thread.join(timeout=5.0)
            if sid is not None:
                self.server.detach(sid)
            if clean_bye:
                try:
                    with send_lock:
                        _send_msg(conn, MSG_BYE)
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                self._live_conns.discard(conn)


class StreamingClient:
    """Minimal blocking client for :class:`SocketServingFront`.

    Usage::

        c = StreamingClient(host, port).hello(dvec)   # or hello() for NS
        c.send(samples); c.send(more)                 # float32 PCM
        out = c.recv_available()                      # incremental reads
        tail = c.finish()                             # BYE + drain + close
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._timeout = timeout
        self.slot: Optional[int] = None
        self.chunk: Optional[int] = None
        self.n_sources: int = 1

    def hello(self, payload: Optional[np.ndarray] = None) -> "StreamingClient":
        buf = (np.ascontiguousarray(payload, np.float32).tobytes()
               if payload is not None else b"")
        _send_msg(self._sock, MSG_HELLO, buf)
        t, body = _recv_msg(self._sock)
        if t == MSG_ERROR:
            raise RuntimeError(f"server refused session: {body.decode()}")
        if t != MSG_ACK:
            raise RuntimeError(f"unexpected reply type {t}")
        self.slot, self.chunk, self.n_sources = struct.unpack("<III", body)
        return self

    def _deinterleave(self, flat: np.ndarray) -> np.ndarray:
        """[T*M] sample-interleaved -> [T] (M == 1) or [M, T]."""
        if self.n_sources <= 1:
            return flat
        return np.ascontiguousarray(
            flat.reshape(-1, self.n_sources).T)

    def send(self, samples: np.ndarray) -> None:
        buf = np.ascontiguousarray(samples, np.float32).tobytes()
        # honor the server's MAX_PAYLOAD cap: split long audio into
        # multiple AUDIO messages (the server concatenates; sample-stream
        # semantics are identical)
        for off in range(0, len(buf) or 1, MAX_PAYLOAD):
            _send_msg(self._sock, MSG_AUDIO, buf[off:off + MAX_PAYLOAD])

    def _read_msg(self) -> Tuple[int, bytes]:
        t, body = _recv_msg(self._sock)
        if t == MSG_ERROR:
            raise RuntimeError(f"server error: {body.decode()}")
        return t, body

    def _try_read_msg(self, timeout: float):
        """Read one complete message, or None if no message STARTS within
        `timeout`. Only the first byte races the timeout — once a message
        has begun, the remainder is read blocking, so framing never skews."""
        self._sock.settimeout(timeout if timeout > 0 else 0.0)
        try:
            first = self._sock.recv(1)
        except (BlockingIOError, socket.timeout, TimeoutError):
            return None
        finally:
            self._sock.settimeout(self._timeout)
        if not first:
            raise ConnectionError("peer closed")
        hdr = first + _recv_exact(self._sock, _HDR.size - 1)
        t, n = _HDR.unpack(hdr)
        if n > MAX_PAYLOAD:
            raise ConnectionError(f"oversized payload ({n} bytes)")
        body = _recv_exact(self._sock, n) if n else b""
        if t == MSG_ERROR:
            raise RuntimeError(f"server error: {body.decode()}")
        return t, body

    def recv_available(self, wait_s: float = 0.0) -> np.ndarray:
        """Return whatever enhanced audio has arrived (waits at most wait_s
        for the first message, then drains without blocking)."""
        chunks = []
        timeout = wait_s
        while True:
            msg = self._try_read_msg(timeout)
            if msg is None:
                break
            timeout = 0.0
            if msg[0] == MSG_AUDIO_OUT:
                chunks.append(np.frombuffer(msg[1], np.float32))
        return self._deinterleave(np.concatenate(chunks) if chunks
                                  else np.empty(0, np.float32))

    def finish(self) -> np.ndarray:
        """Send BYE, collect AUDIO_OUT until the server's BYE, close, and
        return the drained tail (concatenate with earlier reads)."""
        _send_msg(self._sock, MSG_BYE)
        chunks = []
        while True:
            t, body = self._read_msg()
            if t == MSG_BYE:
                break
            if t == MSG_AUDIO_OUT:
                chunks.append(np.frombuffer(body, np.float32))
        self._sock.close()
        return self._deinterleave(np.concatenate(chunks) if chunks
                                  else np.empty(0, np.float32))

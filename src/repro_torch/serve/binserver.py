"""Event-loop binary front end for :class:`~repro_torch.serve.server.
PredictionServer`.

The HTTP front end spends its single-row latency budget on text
framing, header parsing, and a thread handoff per request (and, on the
wire, on ``http.client``'s split header/body writes colliding with
Nagle + delayed ACK).  This front end serves the same codec payloads
behind the fixed 24-byte header from :mod:`repro_torch.serve.framing`, on ONE
``selectors``-based event-loop thread instead of a thread per
connection:

* the loop accepts, reads, parses frames, and writes replies — it never
  evaluates anything and never blocks;
* coalesced table sweeps go straight into the shared
  :class:`~repro_torch.serve.server.Coalescer` via ``submit_async`` — the
  coalescer thread fires an ``on_done`` callback that encodes the reply
  and hands it back to the loop through a completion queue plus a
  socketpair wakeup;
* everything that can block for real time (lattice-spec streams,
  ``coalesce=False`` tables) runs on a small worker pool calling the
  same ``answer_decoded`` path HTTP uses.

Answers are therefore bit-identical across transports: both front ends
feed the identical coalescer/engine and encode with the identical
codec — only the framing differs.

Protocol errors (bad magic, unknown op, duplicate in-flight request id,
oversized frame) poison the connection: the stream offset can no longer
be trusted, so the server closes the socket rather than risk handing a
reply to the wrong request id.  Request-level errors (unknown hardware,
deadline exceeded, overload shed) are answered in-band as
``FLAG_ERROR`` frames carrying a codec ERROR message, and the
connection stays usable.
"""
from __future__ import annotations

import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from ..core.workload import WorkloadTable
from ..obs import metrics, trace
from . import codec, errors
from .codec import WireFormatError
from .framing import (FLAG_ERROR, OP_CACHE_STATS, OP_HEALTH, OP_METRICS,
                      OP_SWEEP, FrameParser, pack_frame)
from .server import DRAIN_RETRY_AFTER_S, _stage_hist

__all__ = ["BinaryFrontend"]

#: per-recv read size: large enough that a fat pipelined burst drains in
#: few syscalls, small enough not to balloon per-connection buffers
_RECV_BYTES = 1 << 18

#: worker threads for requests the event loop must not run inline
#: (streamed lattices, ``coalesce=False`` tables) — table sweeps bypass
#: this pool entirely via the coalescer's async path
_SLOW_POOL_WORKERS = 4


class _Conn:
    """Per-connection state owned by the event-loop thread."""

    __slots__ = ("sock", "parser", "inflight", "out")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parser = FrameParser()
        #: request ids awaiting a reply — duplicates are a protocol
        #: error (an id is the only demux key a pipelining client has)
        self.inflight = set()
        self.out = bytearray()

    @property
    def dead(self) -> bool:
        return self.sock.fileno() == -1


class BinaryFrontend:
    """The binary transport: one listening socket, one event-loop
    thread, shared ``PredictionServer`` behind it.

    Binds in ``__init__`` (so a port collision surfaces before any
    thread starts, mirroring the HTTP front end), serves after
    ``start()``.
    """

    #: stats schema, also used by the HTTP front end to zero-fill when
    #: no binary port is bound so ``cache_stats`` keeps one shape
    STAT_KEYS = ("connections", "connections_open", "frames_in",
                 "frames_out", "requests", "protocol_errors")

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self._stats = {"connections": 0, "frames_in": 0, "frames_out": 0,
                       "requests": 0, "protocol_errors": 0}
        #: one lock over stats mutations + snapshot: the loop thread is
        #: the only writer, but ``cache_stats`` reads from handler
        #: threads and must never see a torn multi-key combination
        self._stats_lock = threading.Lock()
        #: sweep frames accepted but not yet answered (pipeline depth)
        self._inflight_n = 0
        self._m_inflight = metrics.gauge(
            "repro_serve_binary_inflight",
            "Sweep frames in flight on the binary transport")
        self._m_accepted = metrics.counter(
            "repro_serve_binary_connections_total",
            "Connections accepted on the binary port")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self._listener.listen(128)
            self._listener.setblocking(False)
        except BaseException:
            self._listener.close()
            raise
        # loop-wakeup channel: any thread may hand the loop work (reply
        # completions, drain/close flags) by writing one byte here
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._conns: set = set()
        #: cross-thread completion queue: (conn, op, req_id, payload,
        #: flags) tuples appended by coalescer/worker threads, drained
        #: by the loop (deque append/popleft are atomic)
        self._completed: deque = deque()
        self._pool = ThreadPoolExecutor(max_workers=_SLOW_POOL_WORKERS,
                                        thread_name_prefix="serve-bin")
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self._closed = False

    # ------------------------------------------------------------ plumbing
    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    @property
    def stats(self) -> Dict[str, int]:
        return self.stats_snapshot()

    def stats_snapshot(self) -> Dict[str, int]:
        """A mutually consistent copy of the frontend counters."""
        with self._stats_lock:
            out = dict(self._stats)
        out["connections_open"] = len(self._conns)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def _track_inflight(self, delta: int) -> None:
        # loop-thread only — the gauge mirrors it for scrapers
        self._inflight_n += delta
        self._m_inflight.set(self._inflight_n)

    def start(self) -> "BinaryFrontend":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-binary")
            self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop taking new work: new connections are refused and new
        sweep frames answered with an overload error; health/stats
        frames (probes) still answer; queued replies still flush."""
        self._draining = True
        self._wake()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        else:
            # bound but never served: nothing owns the sockets yet
            self._listener.close()
            self._wake_r.close()
            self._wake_w.close()
        self._pool.shutdown(wait=False)

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass                             # full pipe still wakes; closed
            #                                  pipe means the loop is gone

    # ----------------------------------------------------------- the loop
    def _loop(self) -> None:
        sel = self._sel
        sel.register(self._listener, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._closed:
                for key, mask in sel.select(timeout=0.5):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wakeups()
                    else:
                        conn = key.data
                        try:
                            if mask & selectors.EVENT_READ \
                                    and not conn.dead:
                                self._readable(conn)
                            if mask & selectors.EVENT_WRITE \
                                    and not conn.dead:
                                self._flush(conn)
                        except Exception:    # noqa: BLE001 — loop survives
                            self._close_conn(conn)
                self._drain_completed()
        finally:
            for conn in list(self._conns):
                self._close_conn(conn)
            sel.close()
            self._listener.close()
            self._wake_r.close()
            self._wake_w.close()

    def _drain_wakeups(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _accept(self) -> None:
        while True:
            try:
                s, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self._draining or self._closed:
                s.close()
                continue
            s.setblocking(False)
            # one sendall per frame + NODELAY = no Nagle/delayed-ACK
            # stall — the entire point of this transport
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(s)
            self._conns.add(conn)
            self._sel.register(s, selectors.EVENT_READ, conn)
            self._bump("connections")
            self._m_accepted.inc()

    def _close_conn(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        if conn in self._conns and conn.inflight:
            self._track_inflight(-len(conn.inflight))
        self._conns.discard(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_BYTES)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:                         # peer closed / severed
            self._close_conn(conn)
            return
        try:
            conn.parser.feed(data)
            for frame in conn.parser.frames():
                self._bump("frames_in")
                self._handle_frame(conn, frame)
                if conn.dead:                # closed mid-burst
                    return
        except WireFormatError:
            # the stream offset is untrustworthy — close instead of
            # guessing where the next frame starts
            self._bump("protocol_errors")
            self._close_conn(conn)

    # ------------------------------------------------------------ dispatch
    def _handle_frame(self, conn: _Conn, frame) -> None:
        if frame.req_id in conn.inflight:
            # two outstanding requests with one id cannot be demuxed —
            # closing is safer than ever answering the wrong caller
            self._bump("protocol_errors")
            self._close_conn(conn)
            return
        self._bump("requests")
        server = self.server
        server.n_requests += 1
        if frame.op == OP_HEALTH:
            self._send_local(conn, frame.op, frame.req_id,
                             codec.encode_json(server.health()))
            return
        if frame.op == OP_CACHE_STATS:
            self._send_local(conn, frame.op, frame.req_id,
                             codec.encode_json(server.stats()))
            return
        if frame.op == OP_METRICS:
            # the same Prometheus text /v1/metrics serves, wrapped in a
            # MSG_JSON; answers during drain like the other probe ops
            self._send_local(conn, frame.op, frame.req_id,
                             codec.encode_json(server.metrics_text()))
            return
        # OP_SWEEP from here on
        if self._draining or self._closed:
            self._send_local(conn, frame.op, frame.req_id,
                             codec.encode_error(errors.ServerOverloaded(
                                 "server is draining — no new work "
                                 "accepted",
                                 retry_after_s=DRAIN_RETRY_AFTER_S)),
                             flags=FLAG_ERROR)
            return
        deadline = (time.monotonic() + frame.deadline_s
                    if frame.deadline_s > 0.0 else None)
        conn.inflight.add(frame.req_id)
        self._track_inflight(+1)
        t0 = time.monotonic()
        try:
            op, source, meta = codec.decode_request(frame.payload)
            trace_id = trace.coerce_trace_id(meta.get("trace_id"))
            _stage_hist("parse").observe(time.monotonic() - t0,
                                         trace_id=trace_id)
            if isinstance(source, WorkloadTable) \
                    and meta.get("coalesce", True):
                # the fast path: park in the coalescer without blocking;
                # the reply is encoded on the coalescer thread and
                # flushed by the loop after a wakeup
                hw, model, k, objectives, calibration, max_rows = \
                    server._resolve_sweep(meta)
                req_id = frame.req_id

                def on_done(r, conn=conn, op=op, req_id=req_id,
                            trace_id=trace_id, t0=t0):
                    if r.error is not None:
                        payload, flags = codec.encode_error(r.error), \
                            FLAG_ERROR
                    else:
                        try:
                            t_enc = time.monotonic()
                            payload = (codec.encode_totals(r.result)
                                       if op == "predict_table"
                                       else codec.encode_winners(r.result))
                            _stage_hist("encode").observe(
                                time.monotonic() - t_enc,
                                trace_id=trace_id)
                            flags = 0
                        except Exception as e:  # noqa: BLE001
                            payload, flags = codec.encode_error(e), \
                                FLAG_ERROR
                    self._completed.append(
                        (conn, OP_SWEEP, req_id, payload, flags))
                    self._wake()
                    self.server._observe_request(
                        "binary", op, trace_id, time.monotonic() - t0,
                        400 if flags & FLAG_ERROR else 200)

                server.coalescer.submit_async(
                    op, source, hw, model, k=k, objectives=objectives,
                    calibration=calibration, deadline=deadline,
                    max_rows=max_rows, on_done=on_done,
                    trace_id=trace_id)
                return
        except Exception as e:               # noqa: BLE001 — typed reply
            self._send_local(conn, OP_SWEEP, frame.req_id,
                             codec.encode_error(e), flags=FLAG_ERROR)
            return
        # the slow path: lattice specs and coalesce=False tables block
        # for real evaluation time — never on the loop
        self._pool.submit(self._answer_slow, conn, op, source, meta,
                          deadline, frame.req_id, trace_id, t0)

    def _answer_slow(self, conn: _Conn, op, source, meta, deadline,
                     req_id: int, trace_id=None, t0=None) -> None:
        try:
            payload, flags = self.server.answer_decoded(
                op, source, meta, deadline=deadline,
                trace_id=trace_id), 0
        except BaseException as e:           # noqa: BLE001 — typed reply
            payload, flags = codec.encode_error(e), FLAG_ERROR
        self._completed.append((conn, OP_SWEEP, req_id, payload, flags))
        self._wake()
        if t0 is not None:
            self.server._observe_request(
                "binary", op, trace_id, time.monotonic() - t0,
                400 if flags & FLAG_ERROR else 200)

    # -------------------------------------------------------------- output
    def _drain_completed(self) -> None:
        while True:
            try:
                conn, op, req_id, payload, flags = \
                    self._completed.popleft()
            except IndexError:
                return
            if conn.dead:                    # died while evaluating
                continue
            self._send_local(conn, op, req_id, payload, flags)

    def _send_local(self, conn: _Conn, op: int, req_id: int,
                    payload: bytes, flags: int = 0) -> None:
        """Queue one reply frame and push bytes opportunistically (send
        now if the socket will take them — a select round-trip per reply
        would put scheduler latency back on the fast path)."""
        if req_id in conn.inflight:
            conn.inflight.discard(req_id)
            self._track_inflight(-1)
        conn.out += pack_frame(op, req_id, payload, flags=flags)
        self._bump("frames_out")
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.out:
            try:
                sent = conn.sock.send(conn.out)
                del conn.out[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close_conn(conn)
                return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                         if conn.out else 0)
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError):
            pass

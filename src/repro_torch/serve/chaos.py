"""Fault-injection TCP proxy: deterministic chaos for the serve stack.

The source paper validates its models by injecting controlled variation
across four architectures; this module applies the same discipline to
the serving layer.  A ``ChaosProxy`` sits between ``PredictionClient``
and ``PredictionServer`` on loopback and injures the server->client byte
stream on a **seeded, per-connection schedule**, so the fault-tolerance
tests (``tests/test_serve_faults.py``) and the availability-under-chaos
bench section can prove, reproducibly, that every injected fault
surfaces as a typed error or a successful retry — never a hang past the
deadline, a wrong answer, or a corrupted cache.

Fault classes (``FaultSpec.kind``):

    pass      forward untouched (the control)
    delay     hold the response back ``delay_s`` before forwarding — a
              slow peer; the client's read timeout / deadline governs
    stall     forward the request, swallow the response forever — a hung
              peer; only the client's read timeout can save it
    truncate  forward the first ``after_bytes`` of the response, then
              close — a truncated frame (``IncompleteRead`` client-side)
    bitflip   XOR ``flip_mask`` into the response byte at stream offset
              ``flip_at`` — silent corruption; the codec's CRC32
              integrity section is what turns this into a clean
              ``WireFormatError`` instead of a wrong float
    sever     close both directions after ``after_bytes`` (default 0:
              the connection dies before a single response byte)

Faults are assigned per accepted **connection** (a keep-alive connection
carries many requests; after a destructive fault the client reconnects
and the next connection takes the next schedule slot).  The schedule is
a plain list — build it explicitly for pinpoint tests, or with
``seeded_schedule(seed, n)`` for a reproducible mixed barrage; once the
schedule is exhausted, ``default`` (normally ``"pass"``) applies, so a
finite schedule never starves a retrying client.

Beyond the byte-stream injuries, ``kill_server_process`` is the
process-level scenario: SIGKILL the whole server session mid-stream (no
graceful drain, no FIN from the worker pool) and let the client prove
that a vanished peer surfaces as a typed retryable transport error —
and, once retries exhaust against the dead address, that the circuit
breaker opens (``repro_client_breaker_open_total``) so subsequent calls
fail fast instead of each paying a connect timeout.
"""
from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

__all__ = ["ChaosProxy", "FAULT_KINDS", "FaultSpec", "kill_server_process",
           "seeded_schedule"]

FAULT_KINDS = ("pass", "delay", "stall", "truncate", "bitflip", "sever")

_RECV = 65536


class FaultSpec:
    """One connection's injury: a kind plus its parameters."""

    __slots__ = ("kind", "delay_s", "after_bytes", "flip_at", "flip_mask")

    def __init__(self, kind: str, *, delay_s: float = 0.05,
                 after_bytes: int = 0, flip_at: int = 200,
                 flip_mask: int = 0x40):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; valid: "
                             f"{FAULT_KINDS}")
        if not 1 <= int(flip_mask) <= 255:
            raise ValueError(f"flip_mask must be a byte-sized non-zero "
                             f"mask, got {flip_mask}")
        self.kind = kind
        self.delay_s = float(delay_s)
        self.after_bytes = int(after_bytes)
        self.flip_at = int(flip_at)
        self.flip_mask = int(flip_mask)

    def __repr__(self) -> str:
        extras = {"delay": f" delay_s={self.delay_s}",
                  "truncate": f" after_bytes={self.after_bytes}",
                  "sever": f" after_bytes={self.after_bytes}",
                  "bitflip": f" flip_at={self.flip_at} "
                             f"mask={self.flip_mask:#04x}"}
        return f"FaultSpec({self.kind!r}{extras.get(self.kind, '')})"


def _as_spec(fault: Union[str, FaultSpec]) -> FaultSpec:
    return fault if isinstance(fault, FaultSpec) else FaultSpec(fault)


def seeded_schedule(seed: int, n: int,
                    kinds: Sequence[str] = ("pass", "delay", "truncate",
                                            "bitflip", "sever")
                    ) -> List[FaultSpec]:
    """A reproducible mixed schedule: same ``(seed, n, kinds)`` -> the
    exact same fault sequence and parameters, process- and
    machine-independent (``random.Random(seed)`` is specified).  ``stall``
    is excluded by default because each stall costs a full client read
    timeout — opt in where the time budget allows."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(list(kinds))
        out.append(FaultSpec(
            kind,
            delay_s=round(0.01 + 0.04 * rng.random(), 4),
            after_bytes=rng.randrange(0, 64),
            flip_at=rng.randrange(32, 512),
            flip_mask=1 << rng.randrange(8)))
    return out


class ChaosProxy:
    """Forwarding TCP proxy that injures server->client streams.

    ``port=0`` binds an ephemeral loopback port (read ``address`` back).
    ``connection_log`` records the ``FaultSpec`` consumed by each
    accepted connection, in accept order — tests assert against it to
    prove the intended fault actually fired.  Thread-per-connection;
    ``close()`` tears down the listener and every live pipe.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 schedule: Sequence[Union[str, FaultSpec]] = (), *,
                 default: Union[str, FaultSpec] = "pass",
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream_host, int(upstream_port))
        self.schedule = [_as_spec(f) for f in schedule]
        self.default = _as_spec(default)
        self.connection_log: List[FaultSpec] = []
        self._closed = False
        self._lock = threading.Lock()
        self._socks: List[socket.socket] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-accept")
        self._accept_thread.start()

    # ------------------------------------------------------------ plumbing
    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    @property
    def n_connections(self) -> int:
        with self._lock:
            return len(self.connection_log)

    def faults_injected(self) -> int:
        """Connections that were actually injured (kind != pass)."""
        with self._lock:
            return sum(1 for f in self.connection_log if f.kind != "pass")

    def _next_fault(self) -> FaultSpec:
        with self._lock:
            i = len(self.connection_log)
            fault = self.schedule[i] if i < len(self.schedule) \
                else self.default
            self.connection_log.append(fault)
        return fault

    def _track(self, sock: socket.socket) -> socket.socket:
        with self._lock:
            self._socks.append(sock)
        return sock

    # ----------------------------------------------------------- data path
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return                       # listener closed
            fault = self._next_fault()
            self._track(client)
            threading.Thread(target=self._handle, args=(client, fault),
                             daemon=True, name="chaos-pipe").start()

    def _handle(self, client: socket.socket, fault: FaultSpec) -> None:
        if fault.kind == "sever" and fault.after_bytes <= 0:
            # dead before a single byte moves either way
            _close(client)
            return
        try:
            up = socket.create_connection(self.upstream, timeout=10.0)
        except OSError:
            _close(client)
            return
        self._track(up)
        threading.Thread(target=self._pump_up, args=(client, up),
                         daemon=True, name="chaos-up").start()
        self._pump_down(up, client, fault)

    def _pump_up(self, client: socket.socket, up: socket.socket) -> None:
        """client -> upstream, always transparent (requests go through so
        the server does real work; the injury is on the reply path)."""
        try:
            while True:
                data = client.recv(_RECV)
                if not data:
                    break
                up.sendall(data)
        except OSError:
            pass
        finally:
            # half-close toward upstream; the down pump owns full teardown
            try:
                up.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _pump_down(self, up: socket.socket, client: socket.socket,
                   fault: FaultSpec) -> None:
        """upstream -> client with ``fault`` applied."""
        forwarded = 0
        first = True
        try:
            while True:
                data = up.recv(_RECV)
                if not data:
                    break
                if fault.kind == "stall":
                    continue                 # swallow the response forever
                if first and fault.kind == "delay":
                    time.sleep(fault.delay_s)
                first = False
                if fault.kind == "truncate" or fault.kind == "sever":
                    room = fault.after_bytes - forwarded
                    if room <= 0:
                        break
                    data = data[:room]
                elif fault.kind == "bitflip":
                    off = fault.flip_at - forwarded
                    if 0 <= off < len(data):
                        buf = bytearray(data)
                        buf[off] ^= fault.flip_mask
                        data = bytes(buf)
                client.sendall(data)
                forwarded += len(data)
                if fault.kind in ("truncate", "sever") \
                        and forwarded >= fault.after_bytes:
                    break
        except OSError:
            pass
        finally:
            _close(up)
            _close(client)

    def close(self) -> None:
        self._closed = True
        _close(self._listener)
        with self._lock:
            socks, self._socks = list(self._socks), []
        for sock in socks:
            _close(sock)
        self._accept_thread.join(timeout=2.0)

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _close(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.close()
    except OSError:
        pass


def kill_server_process(proc: "subprocess.Popen",
                        timeout_s: float = 10.0) -> int:
    """SIGKILL a server subprocess session mid-stream and reap it.

    The process-level chaos scenario: unlike ``stop_server_subprocess``
    (SIGTERM -> graceful drain -> fallback kill), this kills the whole
    session group immediately — in-flight requests never get a reply
    byte, listening sockets close with RSTs in flight, the worker pool
    dies with its parent.  The client contract under this injury:

      * requests in flight (or sent after death) surface as retryable
        transport errors (``ConnectionError``/``OSError`` family, or
        ``DeadlineExceeded`` once a caller budget expires),
      * after ``breaker_threshold`` consecutive connect failures the
        circuit opens (``CircuitOpenError`` fail-fast; the
        ``repro_client_breaker_open_total`` counter records the
        closed->open transition).

    Returns the reaped exit status (negative signal number on POSIX).
    Falls back to killing the bare PID when the process is not a session
    leader.  Idempotent: killing an already-dead process just reaps it.
    """
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass
    return proc.wait(timeout=timeout_s)

"""Typed fault vocabulary for the serving stack.

Every way the serve stack can refuse, shed, or fail a request maps to
one exception class here, shared by server (which maps them to HTTP
status codes) and client (which reconstructs them from status codes and
decides retryability).  The contract, documented in ``README.md``:

    400  malformed request (``WireFormatError``/``ValueError``/...)
    401  ``Unauthorized``     — mutating endpoint, bad/missing token
    404  unknown endpoint / unknown hardware entry
    411  missing Content-Length
    413  body exceeds ``MAX_BODY_BYTES``
    429  ``RateLimited``      — mutating-endpoint token bucket empty
    503  ``ServerOverloaded`` — coalescer queue beyond its depth bound,
         server draining, or the request's propagated deadline already
         expired (``DeadlineExceeded``)

``RateLimited``/``ServerOverloaded`` replies carry a ``Retry-After``
header; they (plus transport faults) are the *retryable* class — the
client backs off and re-sends because every endpoint is idempotent.
``Unauthorized`` and ordinary 400s are terminal.  ``CircuitOpenError``
and ``DeadlineExceeded`` can also originate purely client-side: a
breaker refusing to touch a dead server, or a per-call deadline running
out before/while retrying.
"""
from __future__ import annotations

#: HTTP header carrying the caller's remaining deadline budget in
#: (float) seconds at send time.  The server sheds work whose budget is
#: already spent — an answer the client has stopped waiting for is pure
#: wasted evaluation.
DEADLINE_HEADER = "X-Repro-Deadline-S"

#: Auth header for the mutating endpoints (``X-Auth-Token: <secret>``;
#: ``Authorization: Bearer <secret>`` is accepted too).
AUTH_HEADER = "X-Auth-Token"


class ServeFault(RuntimeError):
    """Base class for every typed serving fault."""

    #: safe to re-send after backing off (all endpoints are idempotent)
    retryable = False


class Unauthorized(ServeFault):
    """Mutating endpoint called without the server's shared secret."""


class RateLimited(ServeFault):
    """Mutating-endpoint token bucket is empty (HTTP 429)."""

    retryable = True

    def __init__(self, message: str, retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ServerOverloaded(ServeFault):
    """Load shed: coalescer queue beyond its depth bound, or the server
    is draining (HTTP 503 + ``Retry-After``)."""

    retryable = True

    def __init__(self, message: str, retry_after_s: float = 0.05):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServeFault):
    """The request's deadline budget ran out — either server-side (the
    propagated budget expired while queued, HTTP 503) or client-side
    (the per-call ``deadline_s`` elapsed across connect/read/retries)."""


class CircuitOpenError(ServeFault):
    """Client-side circuit breaker is open: recent consecutive connect
    failures mean the server is down — fail fast instead of paying a
    connect timeout per call.  Closes again after a cooldown probe
    succeeds."""

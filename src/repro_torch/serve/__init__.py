"""Prediction-serving subsystem: wire codec + HTTP sweep server + client.

The analytical models answer "what will this kernel cost on B200/MI300A"
in microseconds, which makes them viable as an online pricing service.
This package opens the repo's first cross-process scenario:

``repro_torch.serve.codec``
    Versioned binary wire format for ``WorkloadTable`` (one contiguous
    float64 matrix + two small code arrays — exactly the shape the
    columnar engine consumes, so decode is zero-copy), lazy
    ``LatticeSpec`` plans, and the result types (``SweepWinner`` lists,
    totals columns).

``repro_torch.serve.server``
    Stdlib-only HTTP server that owns one ``SweepEngine`` and a reusable
    worker pool, with request micro-batching: concurrent small requests
    for the same hardware fuse into one columnar evaluation.

``repro_torch.serve.client``
    Blocking client speaking the same codec over ``http.client``, with
    retries + backoff, split connect/read timeouts, per-call deadlines
    and a circuit breaker.

``repro_torch.serve.errors``
    The typed fault vocabulary (``Unauthorized``, ``RateLimited``,
    ``ServerOverloaded``, ``DeadlineExceeded``, ``CircuitOpenError``)
    shared by both sides, plus the status-code contract.

``repro_torch.serve.chaos``
    Deterministic fault-injection TCP proxy (delay/stall/truncate/
    bitflip/sever on a seeded schedule) used by the fault-tolerance
    tests and the availability-under-chaos bench section.

See ``README.md`` in this directory for the wire format, the coalescing
contract, the robustness/status-code contract, and when to hit the
server vs calling ``SweepEngine`` in-process.
"""
from .codec import (WIRE_VERSION, RemoteError, WireFormatError,
                    decode_calibrate_request,
                    decode_calibration, decode_hardware, decode_json,
                    decode_request, decode_spec, decode_suite, decode_table,
                    decode_totals, decode_winners,
                    encode_calibrate_request, encode_calibration,
                    encode_error, encode_hardware, encode_json,
                    encode_request, encode_spec, encode_suite, encode_table,
                    encode_totals, encode_winners, raise_if_error)
from .errors import (CircuitOpenError, DeadlineExceeded, RateLimited,
                     ServeFault, ServerOverloaded, Unauthorized)


def __getattr__(name):
    # lazy so `python -m repro_torch.serve.server` doesn't import the server
    # module twice (once via the package, once as __main__)
    if name == "PredictionClient":
        from .client import PredictionClient
        return PredictionClient
    if name == "PredictionServer":
        from .server import PredictionServer
        return PredictionServer
    if name in ("ChaosProxy", "FaultSpec", "seeded_schedule"):
        from . import chaos
        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "WIRE_VERSION", "ChaosProxy", "CircuitOpenError", "DeadlineExceeded",
    "FaultSpec", "PredictionClient", "PredictionServer", "RateLimited",
    "RemoteError", "ServeFault", "ServerOverloaded", "Unauthorized",
    "WireFormatError", "decode_calibrate_request", "decode_calibration",
    "decode_hardware", "decode_json", "decode_request", "decode_spec",
    "decode_suite", "decode_table", "decode_totals", "decode_winners",
    "encode_calibrate_request", "encode_calibration", "encode_error",
    "encode_hardware", "encode_json", "encode_request", "encode_spec",
    "encode_suite", "encode_table", "encode_totals", "encode_winners",
    "raise_if_error", "seeded_schedule",
]

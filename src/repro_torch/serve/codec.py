"""Versioned binary wire codec for tables, lattice plans and sweep results.

One message is one self-contained byte string:

    offset  size          field
    0       4             magic ``b"RPRW"``
    4       2             wire version (little-endian u16, currently 1)
    6       2             message type (u16, ``MSG_*``)
    8       4             section count (u32)
    12      24 * count    section table: (tag ``4s``, offset u64, len u64)
    ...                   section payloads, each 8-byte aligned

Sections come in two kinds: small structured metadata travels as one
UTF-8 JSON section (``meta``), bulk numeric data travels as raw
little-endian array bytes (``cols``/``pcod``/``wcod``/``tots``).  A
``WorkloadTable`` is therefore exactly its in-memory shape on the wire —
the (n, NV_COLS) float64 matrix plus two int64 code arrays — and decode
is zero-copy: NumPy views over the received buffer, read-only because the
buffer is immutable, which is precisely the frozen-columns contract the
engine's caches rely on.  ``content_token()`` of a decoded table equals
the sender's (property-tested in tests/test_serve_codec.py).

``LatticeSpec`` messages carry the spec's structural plan (JSON, tiny even
for 10^9-row lattices) plus any built tables the plan references as nested
table messages.  Result messages (``SweepWinner`` lists) are pure JSON —
Python's float repr round-trips bit-exactly, and the stdlib encoder/parser
pair handles NaN/Infinity — while totals columns are raw float64.

Wire version 2 adds the hardware-library and calibration-as-data message
types (``MSG_HARDWARE``/``MSG_CALIBRATION``/``MSG_SUITE``/``MSG_CALREQ``):
hardware entries travel as their schema-validated ``hwlib`` documents
(JSON numbers round-trip floats bit-exactly), measured microbench suites
as workload dicts plus a raw float64 measurement column, and fitted
``Calibration`` objects with their full §IV-D multiplier disclosure.
Every version-1 message decodes unchanged (the envelope and types 1-7
did not move) — a v2 decoder accepts ``version <= 2``.

Malformed input (truncated buffers, bad magic, unsupported versions,
out-of-range section offsets, wrong payload sizes) raises
``WireFormatError`` — never an IndexError or struct.error a server loop
would have to treat as a crash.

Integrity: every encoded message carries a ``csum`` section — the CRC32
of all other section payloads in section-table order.  Decode verifies
it when present, so a bit flip anywhere in the payload bytes (a float in
a column, a digit in the meta JSON, a section offset that reframes the
payload) surfaces as ``WireFormatError`` instead of a silently wrong
prediction.  Messages *without* the section (older encoders, hand-built
v1 payloads) still decode — the check is additive, like wire v2 itself.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.workload import LatticeSpec, NV_COLS, TimeBreakdown, \
    WorkloadTable, row_from_tb, tb_from_row

MAGIC = b"RPRW"
WIRE_VERSION = 2

MSG_TABLE = 1
MSG_SPEC = 2
MSG_REQUEST = 3
MSG_WINNERS = 4
MSG_TOTALS = 5
MSG_JSON = 6
MSG_ERROR = 7
# --- wire version 2 --------------------------------------------------------
MSG_HARDWARE = 8
MSG_CALIBRATION = 9
MSG_SUITE = 10
MSG_CALREQ = 11

_HEADER = struct.Struct("<4sHHI")
_SECTION = struct.Struct("<4sQQ")
_MAX_SECTIONS = 1024

Buf = Union[bytes, bytearray, memoryview]


class WireFormatError(ValueError):
    """Raised for any malformed/unsupported wire payload."""


# ---------------------------------------------------------------------------
# Envelope
# ---------------------------------------------------------------------------

#: integrity section tag: CRC32 over every other section payload, in
#: section-table order, as one LE u32
_CSUM_TAG = b"csum"


def _payload_crc(payloads: Sequence[Buf]) -> int:
    crc = 0
    for payload in payloads:
        crc = zlib.crc32(payload, crc)
    return crc


def _pack(msg_type: int, sections: Sequence[Tuple[bytes, Buf]], *,
          checksum: bool = True) -> bytes:
    """Assemble an envelope; each section payload lands 8-byte aligned so
    float64/int64 decode views are aligned views of the message buffer.
    ``checksum`` stamps the ``csum`` integrity section (always on in
    production; tests craft unstamped messages to drive the downstream
    validation paths the checksum would otherwise shadow)."""
    if checksum:
        crc = _payload_crc([payload for _, payload in sections])
        sections = list(sections) + [
            (_CSUM_TAG, struct.pack("<I", crc))]
    count = len(sections)
    table_end = _HEADER.size + _SECTION.size * count
    parts: List[bytes] = []
    entries = []
    pos = table_end
    for tag, payload in sections:
        pad = (-pos) % 8
        if pad:
            parts.append(b"\x00" * pad)
            pos += pad
        entries.append((tag, pos, len(payload)))
        parts.append(bytes(payload))
        pos += len(payload)
    head = [_HEADER.pack(MAGIC, WIRE_VERSION, msg_type, count)]
    head += [_SECTION.pack(tag, off, ln) for tag, off, ln in entries]
    return b"".join(head + parts)


def _unpack(data: Buf) -> Tuple[int, Dict[bytes, memoryview]]:
    """(msg_type, {tag: payload view}) with every bound checked."""
    mv = memoryview(data)
    if len(mv) < _HEADER.size:
        raise WireFormatError(
            f"truncated message: {len(mv)} bytes < {_HEADER.size}-byte "
            f"header")
    magic, version, msg_type, count = _HEADER.unpack_from(mv, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {bytes(magic)!r} "
                              f"(expected {MAGIC!r})")
    if version > WIRE_VERSION or version < 1:
        raise WireFormatError(
            f"unsupported wire version {version} (this codec speaks "
            f"<= {WIRE_VERSION})")
    if count > _MAX_SECTIONS:
        raise WireFormatError(f"section count {count} exceeds "
                              f"{_MAX_SECTIONS}")
    table_end = _HEADER.size + _SECTION.size * count
    if len(mv) < table_end:
        raise WireFormatError(
            f"truncated section table: {len(mv)} bytes < {table_end}")
    sections: Dict[bytes, memoryview] = {}
    crc = 0
    for i in range(count):
        tag, off, ln = _SECTION.unpack_from(
            mv, _HEADER.size + _SECTION.size * i)
        if off < table_end or off + ln > len(mv):
            raise WireFormatError(
                f"section {bytes(tag)!r} spans [{off}, {off + ln}) outside "
                f"payload [{table_end}, {len(mv)})")
        view = mv[off:off + ln]
        sections[bytes(tag)] = view
        if tag != _CSUM_TAG:
            crc = zlib.crc32(view, crc)
    stamped = sections.get(_CSUM_TAG)
    if stamped is not None:
        if len(stamped) != 4:
            raise WireFormatError(
                f"checksum section holds {len(stamped)} bytes, expected 4")
        want = struct.unpack("<I", stamped)[0]
        if crc != want:
            raise WireFormatError(
                f"payload checksum mismatch (crc32 {crc:#010x} != stamped "
                f"{want:#010x}) — message corrupted in transit")
    return msg_type, sections


def _expect(data: Buf, want_type: int, label: str
            ) -> Dict[bytes, memoryview]:
    msg_type, sections = _unpack(data)
    if msg_type != want_type:
        raise WireFormatError(
            f"expected {label} message (type {want_type}), got type "
            f"{msg_type}")
    return sections


def _meta(sections: Dict[bytes, memoryview]) -> Dict:
    raw = sections.get(b"meta")
    if raw is None:
        raise WireFormatError("message is missing its meta section")
    try:
        meta = json.loads(bytes(raw).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"meta section is not valid JSON: {e}") \
            from None
    if not isinstance(meta, dict):
        raise WireFormatError("meta section must be a JSON object")
    return meta


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def _array_section(sections: Dict[bytes, memoryview], tag: bytes,
                   dtype, count: int) -> np.ndarray:
    """Zero-copy typed view over a section, validated against the expected
    element count.  Views of a bytes-backed memoryview are read-only."""
    raw = sections.get(tag)
    if raw is None:
        raise WireFormatError(f"message is missing its {tag!r} section")
    want = count * np.dtype(dtype).itemsize
    if len(raw) != want:
        raise WireFormatError(
            f"section {tag!r} holds {len(raw)} bytes, expected {want} "
            f"({count} x {np.dtype(dtype).name})")
    return np.frombuffer(raw, dtype=dtype)


def message_type(data: Buf) -> int:
    """Peek a message's type (validates the envelope)."""
    return _unpack(data)[0]


# ---------------------------------------------------------------------------
# WorkloadTable
# ---------------------------------------------------------------------------

def encode_table(table: WorkloadTable) -> bytes:
    names = table.names
    if isinstance(names, tuple):
        meta_names: object = list(names)
        names_kind = "rows"
    elif names is None:
        meta_names, names_kind = None, "none"
    else:
        meta_names, names_kind = str(names), "shared"
    hr = None
    if table.hit_rates is not None:
        hr = [None if h is None else sorted(h.items())
              for h in table.hit_rates]
    meta = {
        "n": len(table),
        "nv_cols": NV_COLS,
        "precision_vocab": list(table.precision_vocab),
        "wclass_vocab": list(table.wclass_vocab),
        "names_kind": names_kind,
        "names": meta_names,
        "hit_rates": hr,
        "name_offset": table.name_offset,
    }
    return _pack(MSG_TABLE, [
        (b"meta", _json_bytes(meta)),
        (b"cols", np.ascontiguousarray(table.cols).tobytes()),
        (b"pcod", np.ascontiguousarray(table.precision_codes,
                                       dtype=np.int64).tobytes()),
        (b"wcod", np.ascontiguousarray(table.wclass_codes,
                                       dtype=np.int64).tobytes()),
    ])


def decode_table(data: Buf) -> WorkloadTable:
    """Zero-copy decode: the returned table's columns are read-only NumPy
    views over ``data`` (keep the buffer alive as long as the table)."""
    sections = _expect(data, MSG_TABLE, "table")
    meta = _meta(sections)
    try:
        n = int(meta["n"])
        nv = int(meta["nv_cols"])
        pv = tuple(str(v) for v in meta["precision_vocab"])
        wv = tuple(str(v) for v in meta["wclass_vocab"])
        names_kind = meta["names_kind"]
        name_offset = int(meta["name_offset"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(f"bad table meta: {e}") from None
    if n < 0:
        raise WireFormatError(f"negative row count {n}")
    if nv != NV_COLS:
        raise WireFormatError(
            f"table has {nv} numeric columns, this build expects "
            f"{NV_COLS} — incompatible schema generation")
    cols = _array_section(sections, b"cols", np.float64,
                          n * NV_COLS).reshape(n, NV_COLS)
    pcod = _array_section(sections, b"pcod", np.int64, n)
    wcod = _array_section(sections, b"wcod", np.int64, n)
    if len(pcod) and (pv == () or int(pcod.max()) >= len(pv)
                      or int(pcod.min()) < 0):
        raise WireFormatError("precision codes reference entries outside "
                              "the vocabulary")
    if len(wcod) and (wv == () or int(wcod.max()) >= len(wv)
                      or int(wcod.min()) < 0):
        raise WireFormatError("wclass codes reference entries outside "
                              "the vocabulary")
    if names_kind == "rows":
        names_raw = meta.get("names")
        if not isinstance(names_raw, list) or len(names_raw) != n:
            raise WireFormatError("per-row names must list one name per "
                                  "row")
        names: object = tuple(str(x) for x in names_raw)
    elif names_kind == "shared":
        names = str(meta.get("names"))
    elif names_kind == "none":
        names = None
    else:
        raise WireFormatError(f"unknown names_kind {names_kind!r}")
    hr_raw = meta.get("hit_rates")
    hit_rates = None
    if hr_raw is not None:
        if not isinstance(hr_raw, list) or len(hr_raw) != n:
            raise WireFormatError("hit_rates must list one entry per row")
        try:
            hit_rates = tuple(
                None if h is None else
                {str(k): float(v) for k, v in h} for h in hr_raw)
        except (TypeError, ValueError) as e:
            raise WireFormatError(f"bad hit_rates payload: {e}") from None
    return WorkloadTable(cols, pcod.astype(np.intp, copy=False), pv,
                         wcod.astype(np.intp, copy=False), wv,
                         names, hit_rates, name_offset=name_offset)


# ---------------------------------------------------------------------------
# LatticeSpec
# ---------------------------------------------------------------------------

def encode_spec(spec: LatticeSpec) -> bytes:
    tables: List[WorkloadTable] = []

    def sink(table: WorkloadTable) -> int:
        tables.append(table)
        return len(tables) - 1

    plan = spec.to_plan(sink)
    if len(tables) > 99:
        raise WireFormatError(
            f"plan references {len(tables)} built tables (max 99); "
            f"concat them into one table first")
    sections: List[Tuple[bytes, Buf]] = [
        (b"meta", _json_bytes({"plan": plan}))]
    for i, t in enumerate(tables):
        sections.append((f"tb{i:02d}".encode(), encode_table(t)))
    return _pack(MSG_SPEC, sections)


def decode_spec(data: Buf) -> LatticeSpec:
    sections = _expect(data, MSG_SPEC, "spec")
    meta = _meta(sections)
    plan = meta.get("plan")
    if not isinstance(plan, dict):
        raise WireFormatError("spec meta is missing its plan object")
    tables = []
    for i in range(100):
        raw = sections.get(f"tb{i:02d}".encode())
        if raw is None:
            break
        tables.append(decode_table(raw))
    try:
        return LatticeSpec.from_plan(plan, tables)
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, WireFormatError):
            raise
        raise WireFormatError(f"bad lattice plan: {e}") from None


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

REQUEST_OPS = ("predict_table", "argmin", "topk", "pareto")


def encode_request(op: str, source, *, hw: str,
                   model: Optional[str] = None,
                   k: Optional[int] = None,
                   objectives: Optional[Sequence[str]] = None,
                   chunk_size: Optional[int] = None,
                   jobs=None,
                   coalesce: bool = True,
                   calibration: Optional[str] = None,
                   max_fused_rows: Optional[int] = None,
                   trace_id: Optional[str] = None) -> bytes:
    """One prediction request: an operation + its parameters + the sweep
    source (a built ``WorkloadTable`` or a lazy ``LatticeSpec``).
    Hardware travels by registry name — parameter files live server-side.
    ``calibration`` names a server-side calibration (registered via
    ``/v1/calibrate``) whose multipliers scale the predictions.
    ``max_fused_rows`` is a coalescing hint: cap the estimated row-cost
    budget of any fused batch this request joins (clamped server-side —
    a hint can tighten the server's bound, never raise it).
    ``trace_id`` (16-hex, see ``repro_torch.obs.trace``) propagates a client
    trace through both transports; like ``calibration`` it is additive
    — requests without one stay byte-identical to v1 payloads.
    """
    if op not in REQUEST_OPS:
        raise ValueError(f"unknown op {op!r}; valid: {REQUEST_OPS}")
    meta = {"op": op, "hw": str(hw), "model": model, "k": k,
            "objectives": list(objectives) if objectives else None,
            "chunk_size": chunk_size, "jobs": jobs,
            "coalesce": bool(coalesce)}
    if calibration is not None:
        # only stamped when used: v2 request metas without calibration
        # stay byte-identical to v1 ones
        meta["calibration"] = str(calibration)
    if max_fused_rows is not None:
        if int(max_fused_rows) < 1:
            raise ValueError(
                f"max_fused_rows must be >= 1, got {max_fused_rows}")
        meta["max_fused_rows"] = int(max_fused_rows)
    if trace_id is not None:
        meta["trace_id"] = str(trace_id)
    sections: List[Tuple[bytes, Buf]] = [(b"meta", _json_bytes(meta))]
    if isinstance(source, WorkloadTable):
        sections.append((b"tabl", encode_table(source)))
    elif isinstance(source, LatticeSpec):
        sections.append((b"spec", encode_spec(source)))
    else:
        raise TypeError(f"source must be WorkloadTable or LatticeSpec, "
                        f"got {type(source).__name__}")
    return _pack(MSG_REQUEST, sections)


def decode_request(data: Buf):
    """(op, source, params dict).  ``source`` is a WorkloadTable or a
    LatticeSpec; params carries hw/model/k/objectives/chunk_size/jobs/
    coalesce exactly as sent."""
    sections = _expect(data, MSG_REQUEST, "request")
    meta = _meta(sections)
    op = meta.get("op")
    if op not in REQUEST_OPS:
        raise WireFormatError(f"unknown request op {op!r}")
    if not isinstance(meta.get("hw"), str):
        raise WireFormatError("request is missing its hardware name")
    table_raw = sections.get(b"tabl")
    spec_raw = sections.get(b"spec")
    if (table_raw is None) == (spec_raw is None):
        raise WireFormatError(
            "request must carry exactly one of a table or a spec section")
    source = decode_table(table_raw) if table_raw is not None \
        else decode_spec(spec_raw)
    return op, source, meta


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

def _tb_to_jsonable(tb: TimeBreakdown) -> Dict:
    fields, dkeys, dvals = row_from_tb(tb)
    return {"fields": list(fields), "detail_keys": list(dkeys),
            "detail_vals": list(dvals)}


def _tb_from_jsonable(d: Dict) -> TimeBreakdown:
    try:
        return tb_from_row((tuple(float(v) for v in d["fields"]),
                            tuple(str(k) for k in d["detail_keys"]),
                            tuple(float(v) for v in d["detail_vals"])))
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(f"bad breakdown payload: {e}") from None


def encode_winners(winners) -> bytes:
    """A ``SweepWinner`` list (argmin returns a list of one).  Floats are
    JSON round-trip exact (repr shortest round-trip; NaN/Infinity via the
    stdlib's JSON extension)."""
    if not isinstance(winners, (list, tuple)):
        winners = [winners]
    meta = {"winners": [
        {"index": w.index, "name": w.name, "total": w.total,
         "breakdown": _tb_to_jsonable(w.breakdown)} for w in winners]}
    return _pack(MSG_WINNERS, [(b"meta", json.dumps(meta).encode("utf-8"))])


def decode_winners(data: Buf):
    from ..core.sweep import SweepWinner
    sections = _expect(data, MSG_WINNERS, "winners")
    meta = _meta(sections)
    raw = meta.get("winners")
    if not isinstance(raw, list):
        raise WireFormatError("winners meta is missing its list")
    out = []
    for d in raw:
        try:
            out.append(SweepWinner(
                index=int(d["index"]), name=str(d["name"]),
                total=float(d["total"]),
                breakdown=_tb_from_jsonable(d["breakdown"])))
        except (KeyError, TypeError, ValueError) as e:
            if isinstance(e, WireFormatError):
                raise
            raise WireFormatError(f"bad winner payload: {e}") from None
    return out


def encode_totals(totals: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(totals, dtype=np.float64)
    return _pack(MSG_TOTALS, [
        (b"meta", _json_bytes({"n": int(arr.shape[0])})),
        (b"tots", arr.tobytes()),
    ])


def decode_totals(data: Buf) -> np.ndarray:
    """Read-only zero-copy float64 view over the message buffer."""
    sections = _expect(data, MSG_TOTALS, "totals")
    meta = _meta(sections)
    try:
        n = int(meta["n"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(f"bad totals meta: {e}") from None
    return _array_section(sections, b"tots", np.float64, n)


def encode_json(obj, msg_type: int = MSG_JSON) -> bytes:
    """Small structured payloads (health, cache stats)."""
    return _pack(msg_type, [(b"meta", json.dumps(
        {"payload": obj}).encode("utf-8"))])


def decode_json(data: Buf):
    sections = _expect(data, MSG_JSON, "json")
    return _meta(sections).get("payload")


# ---------------------------------------------------------------------------
# Wire version 2: hardware library + calibration-as-data
# ---------------------------------------------------------------------------

def encode_hardware(entry) -> bytes:
    """A hardware-library entry (``hwlib.HardwareEntry`` or a bare
    ``HardwareParams``) as its schema-validated document.  JSON floats
    round-trip bit-exactly, so a decoded entry predicts identically to
    the sender's."""
    from ..core import hwlib
    if not isinstance(entry, hwlib.HardwareEntry):
        entry = hwlib.HardwareEntry(params=entry)
    return _pack(MSG_HARDWARE, [(b"meta", _json_bytes(
        {"entry": entry.to_doc()}))])


def decode_hardware(data: Buf):
    """-> ``hwlib.HardwareEntry`` (schema-validated; a payload that fails
    the hardware schema raises ``WireFormatError``)."""
    from ..core import hwlib
    sections = _expect(data, MSG_HARDWARE, "hardware")
    meta = _meta(sections)
    doc = meta.get("entry")
    if not isinstance(doc, dict):
        raise WireFormatError("hardware message is missing its entry "
                              "document")
    try:
        return hwlib.load_entry(doc, where="<wire>")
    except hwlib.HardwareSchemaError as e:
        raise WireFormatError(f"bad hardware entry: {e}") from None


def encode_calibration(cal, report: Optional[Dict] = None) -> bytes:
    """A fitted ``core.calibrate.Calibration`` with its full multiplier
    disclosure (paper §IV-D: factors must be disclosed — the wire form IS
    the disclosure), plus the optional train/holdout report."""
    return _pack(MSG_CALIBRATION, [(b"meta", json.dumps(
        {"calibration": cal.to_dict(), "report": report}).encode("utf-8"))])


def decode_calibration(data: Buf):
    """-> (``Calibration``, report dict | None)."""
    from ..core.calibrate import Calibration
    sections = _expect(data, MSG_CALIBRATION, "calibration")
    meta = _meta(sections)
    try:
        cal = Calibration.from_dict(meta.get("calibration"))
    except ValueError as e:
        raise WireFormatError(f"bad calibration payload: {e}") from None
    report = meta.get("report")
    if report is not None and not isinstance(report, dict):
        raise WireFormatError("calibration report must be an object")
    return cal, report


def encode_suite(suite) -> bytes:
    """A measured microbench suite (``microbench.MeasuredSuite``):
    workload characterizations as JSON, the measured medians as one raw
    float64 column."""
    meas = np.ascontiguousarray(suite.measured_s, dtype=np.float64)
    meta = {"name": suite.name,
            "workloads": [w.to_dict() for w in suite.workloads],
            "meta": dict(suite.meta), "n": int(meas.shape[0])}
    return _pack(MSG_SUITE, [(b"meta", _json_bytes(meta)),
                             (b"meas", meas.tobytes())])


def decode_suite(data: Buf):
    """-> ``microbench.MeasuredSuite`` (measured column read as float64)."""
    from ..core.microbench import MeasuredSuite
    sections = _expect(data, MSG_SUITE, "suite")
    meta = _meta(sections)
    try:
        n = int(meta["n"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(f"bad suite meta: {e}") from None
    meas = _array_section(sections, b"meas", np.float64, n)
    try:
        return MeasuredSuite.from_dict(
            {"name": meta.get("name"), "workloads": meta.get("workloads"),
             "measured_s": meas.tolist(), "meta": meta.get("meta")})
    except ValueError as e:
        raise WireFormatError(str(e)) from None


CALIBRATE_MODES = ("case", "class")


def encode_calibrate_request(suite, *, hw: str, mode: str = "class",
                             holdout_fraction: float = 0.3, seed: int = 0,
                             model: Optional[str] = None,
                             register_as: Optional[str] = None) -> bytes:
    """'Here are my measured times — fit multipliers against your
    predictions.'  ``register_as`` stores the fit server-side under that
    name so follow-up sweep requests can price against it
    (``encode_request(..., calibration=name)``)."""
    if mode not in CALIBRATE_MODES:
        raise ValueError(f"unknown calibrate mode {mode!r}; valid: "
                         f"{CALIBRATE_MODES}")
    meta = {"hw": str(hw), "mode": mode,
            "holdout_fraction": float(holdout_fraction), "seed": int(seed),
            "model": model, "register_as": register_as}
    return _pack(MSG_CALREQ, [(b"meta", _json_bytes(meta)),
                              (b"suit", encode_suite(suite))])


def decode_calibrate_request(data: Buf):
    """-> (``MeasuredSuite``, params dict with hw/mode/holdout_fraction/
    seed/model/register_as)."""
    sections = _expect(data, MSG_CALREQ, "calibrate-request")
    meta = _meta(sections)
    if not isinstance(meta.get("hw"), str):
        raise WireFormatError("calibrate request is missing its hardware "
                              "name")
    if meta.get("mode") not in CALIBRATE_MODES:
        raise WireFormatError(f"unknown calibrate mode "
                              f"{meta.get('mode')!r}")
    raw = sections.get(b"suit")
    if raw is None:
        raise WireFormatError("calibrate request is missing its suite "
                              "section")
    return decode_suite(raw), meta


class RemoteError(RuntimeError):
    """A server-side failure, re-raised client-side with the original
    exception class name preserved in the message."""


def encode_error(exc: BaseException) -> bytes:
    meta = {"error": type(exc).__name__, "message": str(exc)}
    # ServeFault retry hints travel in-band: the binary transport has no
    # Retry-After header, so the error payload itself carries the hint
    # (additive key — older decoders ignore it)
    retry_after = getattr(exc, "retry_after_s", None)
    if retry_after is not None:
        meta["retry_after_s"] = float(retry_after)
    return _pack(MSG_ERROR, [(b"meta", _json_bytes(meta))])


def decode_error(data: Buf) -> Tuple[str, str, Optional[float]]:
    """Decode an ERROR message to ``(class name, message,
    retry_after_s | None)`` without raising it — the binary client uses
    this to rebuild the server's typed fault (``ServerOverloaded`` et
    al. carry their retryability in the class)."""
    meta = _meta(_expect(data, MSG_ERROR, "error"))
    retry_after = meta.get("retry_after_s")
    if retry_after is not None:
        try:
            retry_after = float(retry_after)
        except (TypeError, ValueError):
            raise WireFormatError(
                f"bad retry_after_s {retry_after!r}") from None
    return (str(meta.get("error", "Error")), str(meta.get("message", "")),
            retry_after)


def raise_if_error(data: Buf) -> None:
    """Raise ``RemoteError`` when ``data`` is an error message; no-op (and
    no validation beyond the envelope) otherwise."""
    if message_type(data) == MSG_ERROR:
        meta = _meta(_unpack(data)[1])
        raise RemoteError(f"{meta.get('error', 'Error')}: "
                          f"{meta.get('message', '')}")

"""Declarative hardware library: schema-validated, file-loadable parameters.

The paper's central portability claim (Obs. 6, §V-E) is that the models
move across architectures by *swapping parameter files, not formulas* —
B200→H200 and MI300A→MI250X port with "no major restructuring".  This
module makes that literal: a ``HardwareParams`` is (de)serializable to a
plain JSON document, every shipped accelerator lives as a data file under
``core/hwdata/*.json``, and adding a new accelerator is a data entry, not
a code change.

File format (schema version 1)::

    {
      "schema_version": 1,
      "params":     { ... every HardwareParams field ... },
      "provenance": { "hbm_sustained_bw": "microbench", ... },
      "units":      { "hbm_sustained_bw": "bytes/s", ... },
      "source":     "free-text citation",
      "notes":      "free text"
    }

``params`` is the output of :func:`to_dict`: scalar fields verbatim,
per-precision throughput dicts as JSON objects, ``cache_levels`` as a
list of ``{name, capacity_bytes, latency_cycles, bandwidth}`` objects
(L1→LLC order; bytes / cycles / bytes-per-second).  JSON numbers
round-trip bit-exactly (Python's shortest-repr floats), so a loaded
entry predicts bit-identically to the constructor it replaced — the
golden parity tests in tests/test_hwlib.py pin this.

``provenance`` mirrors paper Table II's *Source* column: each tag records
whether a value was measured by a microbenchmark, copied from a vendor
datasheet, derived from another value, or assumed.  ``units`` entries are
optional redundancy: when present they must match the canonical unit the
schema assigns to that field (:data:`FIELD_UNITS`) — a file claiming
``"hbm_peak_bw": "GB/s"`` is rejected, because the loader cannot know
whether the *value* was scaled to match the wrong unit.

Validation errors raise :class:`HardwareSchemaError` with the file path
and the offending key; unknown field names include close-match
suggestions.  The process-wide cache token (``_sweep_content_token``,
stashed by ``core.sweep.hardware_key``) is never serialized — it is not a
dataclass field, and tests assert it never leaks into ``to_dict``.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .hardware import BYTES_PER_ELEM, CacheLevel, HardwareParams

SCHEMA_VERSION = 1

#: model_family values the sweep router understands (core.sweep routes
#: blackwell->stage, cdna->wavefront, tpu->tpu, generic->generic).
KNOWN_FAMILIES = ("blackwell", "cdna", "tpu", "generic")

#: paper Table II "Source" column values, plus the two tags honest
#: parameter files need for values the paper/vendor never published.
PROVENANCE_TAGS = ("microbench", "datasheet", "derived", "assumed")

#: top-level keys a data file may carry.
DOC_KEYS = ("schema_version", "params", "provenance", "units", "source",
            "notes")

_NAME_RE = re.compile(r"^[a-z0-9_]+$")

#: canonical unit per field (the ``units`` section must agree).  Scalar
#: fields are seconds/bytes/FLOP-per-second/bytes-per-second exactly as
#: core/hardware.py documents; the two llc_*_mb boundary knobs keep the
#: paper Table III's megabyte convention.
FIELD_UNITS: Dict[str, str] = {
    "num_sms": "count", "warp_size": "count",
    "max_resident_warps": "count", "vgpr_per_cu": "count",
    "ici_links_per_axis": "count",
    "clock_ghz": "GHz",
    "tensor_peak_flops": "flop/s", "tensor_sustained_flops": "flop/s",
    "vector_peak_flops": "flop/s", "vector_sustained_flops": "flop/s",
    "hbm_peak_bw": "bytes/s", "hbm_sustained_bw": "bytes/s",
    "accum_read_bw": "bytes/s", "accum_write_bw": "bytes/s",
    "tma_bandwidth": "bytes/s", "decomp_engine_rate": "bytes/s",
    "h2d_bandwidth": "bytes/s", "d2h_bandwidth": "bytes/s",
    "ici_link_bw": "bytes/s", "dci_link_bw": "bytes/s",
    "hbm_capacity": "bytes", "accum_capacity_bytes": "bytes",
    "working_set_scale_bytes": "bytes",
    "hbm_latency_cycles": "cycles", "tma_latency_cycles": "cycles",
    "mma_latency_cycles": "cycles", "mbarrier_latency_cycles": "cycles",
    "commit_latency_cycles": "cycles",
    "tmem_alloc_latency_s": "seconds", "coherence_latency_s": "seconds",
    "cross_xcd_latency_s": "seconds", "tau_interference_s": "seconds",
    "tau_interference_gpu_s": "seconds", "tau_fusion_s": "seconds",
    "launch_latency_s": "seconds", "tau_memcpy_s": "seconds",
    "tau_sync_s": "seconds",
    "llc_resident_mb": "MB", "llc_capacity_mb": "MB",
    "decomp_efficiency": "ratio", "two_sm_speedup": "ratio",
    "llc_transition_alpha": "ratio", "llc_transition_beta": "ratio",
    "mfma_utilization": "ratio", "pipeline_overlap_alpha": "ratio",
    "class_scales": "ratio", "precision_efficiency": "ratio",
}

_FIELDS = {f.name: f for f in dataclasses.fields(HardwareParams)}
REQUIRED_FIELDS = tuple(
    f.name for f in dataclasses.fields(HardwareParams)
    if f.default is dataclasses.MISSING
    and f.default_factory is dataclasses.MISSING)
_INT_FIELDS = tuple(n for n, f in _FIELDS.items() if f.type == "int")
_STR_FIELDS = ("name", "vendor", "model_family")
_DICT_FIELDS = ("tensor_peak_flops", "tensor_sustained_flops",
                "vector_peak_flops", "vector_sustained_flops",
                "class_scales", "precision_efficiency")
_PRECISION_DICTS = _DICT_FIELDS[:4] + ("precision_efficiency",)
_CACHE_LEVEL_KEYS = ("name", "capacity_bytes", "latency_cycles",
                     "bandwidth")


class HardwareSchemaError(ValueError):
    """A data file / entry dict violates the declarative schema."""


def _fail(where: str, msg: str) -> None:
    raise HardwareSchemaError(f"{where}: {msg}")


def _suggest(key: str, known) -> str:
    close = difflib.get_close_matches(key, list(known), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def _check_number(where: str, key: str, v, *, integer: bool = False):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(where, f"field {key!r} must be a number, got "
                     f"{type(v).__name__}")
    if integer and not isinstance(v, int):
        _fail(where, f"field {key!r} must be an integer, got {v!r}")
    return v


# ---------------------------------------------------------------------------
# to_dict / from_dict
# ---------------------------------------------------------------------------

def to_dict(params: HardwareParams) -> Dict:
    """JSON-safe dict of every dataclass field (and nothing else — the
    process-local ``_sweep_content_token`` is not a field and never
    serializes).  ``cache_levels`` become a list of plain dicts."""
    out: Dict = {}
    for name in _FIELDS:
        v = getattr(params, name)
        if name == "cache_levels":
            v = [{"name": c.name, "capacity_bytes": c.capacity_bytes,
                  "latency_cycles": c.latency_cycles,
                  "bandwidth": c.bandwidth} for c in v]
        elif isinstance(v, dict):
            v = dict(v)
        out[name] = v
    return out


def from_dict(d: Dict, *, where: str = "<dict>") -> HardwareParams:
    """Validated inverse of :func:`to_dict`.

    Rejects unknown fields (with a close-match suggestion), missing
    required keys, wrong value types, unknown precisions in the
    per-precision throughput dicts, unknown ``model_family`` values, and
    malformed ``cache_levels`` — each with an error naming ``where``.
    """
    if not isinstance(d, dict):
        _fail(where, f"params must be a JSON object, got "
                     f"{type(d).__name__}")
    unknown = set(d) - set(_FIELDS)
    if unknown:
        key = sorted(unknown)[0]
        _fail(where, f"unknown field {key!r}{_suggest(key, _FIELDS)}; "
                     f"schema fields are defined by HardwareParams")
    missing = [k for k in REQUIRED_FIELDS if k not in d]
    if missing:
        _fail(where, f"missing required field(s): {', '.join(missing)}")

    kw: Dict = {}
    for key, v in d.items():
        if key in _STR_FIELDS:
            if not isinstance(v, str) or not v:
                _fail(where, f"field {key!r} must be a non-empty string")
            if key == "name" and not _NAME_RE.match(v):
                _fail(where, f"name {v!r} must match {_NAME_RE.pattern} "
                             f"(registry keys double as file stems)")
            if key == "model_family" and v not in KNOWN_FAMILIES:
                _fail(where, f"unknown model_family {v!r}; the sweep "
                             f"router knows {KNOWN_FAMILIES}")
        elif key in _DICT_FIELDS:
            if not isinstance(v, dict):
                _fail(where, f"field {key!r} must be an object, got "
                             f"{type(v).__name__}")
            for pk, pv in v.items():
                if key in _PRECISION_DICTS and pk not in BYTES_PER_ELEM:
                    _fail(where, f"{key}[{pk!r}]: unknown precision"
                                 f"{_suggest(pk, BYTES_PER_ELEM)}; known: "
                                 f"{sorted(BYTES_PER_ELEM)}")
                _check_number(where, f"{key}[{pk!r}]", pv)
            v = dict(v)
        elif key == "cache_levels":
            if not isinstance(v, (list, tuple)):
                _fail(where, "cache_levels must be a list (L1->LLC order)")
            levels = []
            for i, c in enumerate(v):
                if not isinstance(c, dict):
                    _fail(where, f"cache_levels[{i}] must be an object")
                bad = set(c) ^ set(_CACHE_LEVEL_KEYS)
                if bad:
                    _fail(where, f"cache_levels[{i}] must have exactly "
                                 f"the keys {_CACHE_LEVEL_KEYS} "
                                 f"(got {sorted(c)})")
                if not isinstance(c["name"], str) or not c["name"]:
                    _fail(where, f"cache_levels[{i}].name must be a "
                                 f"non-empty string")
                for nk in _CACHE_LEVEL_KEYS[1:]:
                    _check_number(where, f"cache_levels[{i}].{nk}", c[nk])
                levels.append(CacheLevel(c["name"], c["capacity_bytes"],
                                         c["latency_cycles"],
                                         c["bandwidth"]))
            v = tuple(levels)
        else:
            _check_number(where, key, v, integer=key in _INT_FIELDS)
        kw[key] = v
    return HardwareParams(**kw)


# ---------------------------------------------------------------------------
# Data files
# ---------------------------------------------------------------------------

@dataclass
class HardwareEntry:
    """One loaded library entry: the parameters plus their audit trail."""

    params: HardwareParams
    provenance: Dict[str, str] = field(default_factory=dict)
    units: Dict[str, str] = field(default_factory=dict)
    source: str = ""
    notes: str = ""
    path: Optional[str] = None

    def to_doc(self) -> Dict:
        doc: Dict = {"schema_version": SCHEMA_VERSION,
                     "params": to_dict(self.params)}
        if self.provenance:
            doc["provenance"] = dict(sorted(self.provenance.items()))
        if self.units:
            doc["units"] = dict(sorted(self.units.items()))
        if self.source:
            doc["source"] = self.source
        if self.notes:
            doc["notes"] = self.notes
        return doc


def load_entry(doc: Dict, *, where: str = "<doc>") -> HardwareEntry:
    """Validate one file-level document (see module docstring) into a
    :class:`HardwareEntry`."""
    if not isinstance(doc, dict):
        _fail(where, f"document must be a JSON object, got "
                     f"{type(doc).__name__}")
    unknown = set(doc) - set(DOC_KEYS)
    if unknown:
        key = sorted(unknown)[0]
        _fail(where, f"unknown top-level key {key!r}"
                     f"{_suggest(key, DOC_KEYS)}; valid: {DOC_KEYS}")
    sv = doc.get("schema_version")
    if sv is None:
        _fail(where, "missing required key 'schema_version'")
    if sv != SCHEMA_VERSION:
        _fail(where, f"schema_version {sv!r} unsupported (this build "
                     f"reads version {SCHEMA_VERSION})")
    if "params" not in doc:
        _fail(where, "missing required key 'params'")
    params = from_dict(doc["params"], where=f"{where}.params")

    prov = doc.get("provenance", {})
    if not isinstance(prov, dict):
        _fail(where, "provenance must be an object")
    for k, v in prov.items():
        if k not in _FIELDS:
            _fail(where, f"provenance names unknown field {k!r}"
                         f"{_suggest(k, _FIELDS)}")
        if v not in PROVENANCE_TAGS:
            _fail(where, f"provenance[{k!r}]: tag {v!r} not in "
                         f"{PROVENANCE_TAGS} (paper Table II Source "
                         f"column)")
    units = doc.get("units", {})
    if not isinstance(units, dict):
        _fail(where, "units must be an object")
    for k, v in units.items():
        want = FIELD_UNITS.get(k)
        if want is None:
            _fail(where, f"units names unknown/unitless field {k!r}"
                         f"{_suggest(k, FIELD_UNITS)}")
        if v != want:
            _fail(where, f"units[{k!r}] is {v!r} but the schema defines "
                         f"{k} in {want!r} — rescale the value, don't "
                         f"redeclare the unit")
    for k in ("source", "notes"):
        if k in doc and not isinstance(doc[k], str):
            _fail(where, f"{k} must be a string")
    return HardwareEntry(params=params, provenance=dict(prov),
                         units=dict(units), source=doc.get("source", ""),
                         notes=doc.get("notes", ""))


def load_file(path: str) -> HardwareEntry:
    """Load + validate one ``*.json`` parameter file."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise HardwareSchemaError(f"{path}: not valid JSON: {e}") from None
    entry = load_entry(doc, where=os.path.basename(path))
    entry.path = path
    stem = os.path.splitext(os.path.basename(path))[0]
    if entry.params.name != stem:
        _fail(path, f"file stem {stem!r} must equal the entry name "
                    f"{entry.params.name!r} (the registry lazy-loads by "
                    f"stem)")
    return entry


def save_file(path: str, entry: HardwareEntry) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entry.to_doc(), f, indent=1, sort_keys=False)
        f.write("\n")


def library_file(name: str) -> Optional[str]:
    """Path of the shipped data file for ``name`` under ``core/hwdata``
    (None when the entry is not file-backed — e.g. registered at
    runtime)."""
    from . import hardware
    path = os.path.join(hardware.DATA_DIR, f"{name}.json")
    return path if os.path.isfile(path) else None


def load_dir(dirpath: str) -> List[HardwareEntry]:
    """Validate every ``*.json`` under ``dirpath`` (sorted by name)."""
    out = []
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".json"):
            out.append(load_file(os.path.join(dirpath, fn)))
    return out


def install(path: str, *, overwrite: bool = False) -> HardwareParams:
    """Load a parameter file and register it.

    Goes through :func:`repro.core.hardware.register`, so a bad data file
    cannot silently shadow a shipped entry (``b200`` et al.) — collisions
    raise unless ``overwrite=True``.
    """
    from . import hardware
    entry = load_file(path)
    hardware.register(entry.params, overwrite=overwrite)
    return entry.params


# ---------------------------------------------------------------------------
# diff: the paper's "what changed in the port" as a query
# ---------------------------------------------------------------------------

@dataclass
class ParamDiff:
    """Field-level delta between two parameter files (paper §V-E: the
    B200→H200 port *is* this list).  Keys are dotted/indexed paths —
    ``hbm_peak_bw``, ``tensor_peak_flops.fp8``,
    ``cache_levels[1].bandwidth``."""

    a_name: str
    b_name: str
    changed: Dict[str, Tuple[object, object]] = field(default_factory=dict)
    added: Dict[str, object] = field(default_factory=dict)
    removed: Dict[str, object] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.changed or self.added or self.removed)

    def fields(self) -> Tuple[str, ...]:
        """Top-level HardwareParams field names touched by this diff."""
        keys = list(self.changed) + list(self.added) + list(self.removed)
        return tuple(sorted({k.split(".")[0].split("[")[0] for k in keys}))

    def format(self) -> str:
        lines = [f"diff {self.a_name} -> {self.b_name}: "
                 f"{len(self.changed)} changed, {len(self.added)} added, "
                 f"{len(self.removed)} removed"]
        for k in sorted(self.changed):
            a, b = self.changed[k]
            lines.append(f"  ~ {k}: {a!r} -> {b!r}")
        for k in sorted(self.added):
            lines.append(f"  + {k}: {self.added[k]!r}")
        for k in sorted(self.removed):
            lines.append(f"  - {k}: {self.removed[k]!r}")
        return "\n".join(lines)


def diff(a: HardwareParams, b: HardwareParams) -> ParamDiff:
    """Report changed/added/removed parameters between two entries.

    Dict-valued fields (per-precision throughputs, class scales) diff per
    key; ``cache_levels`` diff per level attribute, with whole levels
    added/removed when the hierarchies differ in depth.  Values compare
    by ``==`` (an int 0 and float 0.0 do not count as a change).
    """
    out = ParamDiff(a_name=a.name, b_name=b.name)
    for name in _FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "cache_levels":
            for i in range(max(len(va), len(vb))):
                if i >= len(va):
                    out.added[f"cache_levels[{i}]"] = to_dict(b)[
                        "cache_levels"][i]
                elif i >= len(vb):
                    out.removed[f"cache_levels[{i}]"] = to_dict(a)[
                        "cache_levels"][i]
                else:
                    for attr in _CACHE_LEVEL_KEYS:
                        x, y = getattr(va[i], attr), getattr(vb[i], attr)
                        if x != y:
                            out.changed[f"cache_levels[{i}].{attr}"] = (
                                x, y)
        elif isinstance(va, dict):
            for k in sorted(set(va) | set(vb)):
                if k not in va:
                    out.added[f"{name}.{k}"] = vb[k]
                elif k not in vb:
                    out.removed[f"{name}.{k}"] = va[k]
                elif va[k] != vb[k]:
                    out.changed[f"{name}.{k}"] = (va[k], vb[k])
        elif va != vb:
            out.changed[name] = (va, vb)
    return out

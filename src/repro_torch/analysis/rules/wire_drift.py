"""WIRE-DRIFT: the binary wire format only changes additively.

Persisted tables and live clients both speak the ``RPRW`` codec and the
``RPB1`` frame; the v1->v2 transition (checksum section) set the
precedent — old payloads must keep decoding, so the format evolves by
*adding* message types / section tags / ops, never by renumbering,
removing, or repacking.

The rule statically extracts the wire surface from ``serve/codec.py``
and ``serve/framing.py`` — magic tags, ``WIRE_VERSION``, the ``MSG_*``
table, header/section struct formats, the 4-byte section-tag universe,
``REQUEST_OPS``/``CALIBRATE_MODES``, ``OP_*``/``FLAG_*`` and frame
limits — and diffs it against the committed
``src/repro_torch/analysis/wire_schema.lock.json``:

* **breaking** drift (changed/removed constant, repacked struct) fails
  with a "bump the version" message: bump ``WIRE_VERSION``, keep the old
  decode path, then refresh the lock;
* **additive** drift (new message type, new tag) also fails — the lock
  must move with the code — but the fix is just
  ``python -m repro_torch.analysis --update-wire-lock`` plus a
  review of the new surface.

Both directions gate, so the committed lock is always the reviewed
source of truth for what's on the wire.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from ..astutil import const_value, iter_module_scope
from ..core import Finding, Project, Rule, register

LOCK_REL = "src/repro_torch/analysis/wire_schema.lock.json"
CODEC_REL = "src/repro_torch/serve/codec.py"
FRAMING_REL = "src/repro_torch/serve/framing.py"

#: lock sections whose *sets* may grow but never shrink or change
_ADDITIVE_MAPS = ("messages", "ops", "flags")
_ADDITIVE_LISTS = ("section_tags", "request_ops", "calibrate_modes")


def _assign_name(stmt: ast.stmt) -> Optional[str]:
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    return None


def _struct_format(stmt: ast.Assign) -> Optional[str]:
    v = stmt.value
    if isinstance(v, ast.Call) and v.args \
            and isinstance(v.args[0], ast.Constant) \
            and isinstance(v.args[0].value, str):
        return v.args[0].value
    return None


def _bytes_str(value: bytes) -> str:
    return value.decode("latin-1")


def _try_const(node: ast.AST):
    """const_value or None — derived module constants (lookup dicts like
    framing.OP_NAMES) are not wire surface and are skipped."""
    try:
        return const_value(node)
    except ValueError:
        return None


def extract_schema(project: Project) -> Tuple[Dict, Dict[str, Tuple[str, int]]]:
    """(schema, locations): the wire surface as a JSON-able dict plus a
    ``dotted.key -> (rel, line)`` map for pointed findings."""
    schema: Dict = {"codec": {}, "framing": {}}
    where: Dict[str, Tuple[str, int]] = {}

    codec = project.tree(CODEC_REL)
    if codec is not None:
        c = schema["codec"]
        c["messages"] = {}
        for stmt in iter_module_scope(codec):
            name = _assign_name(stmt)
            if name is None:
                continue
            loc = (CODEC_REL, stmt.lineno)
            if name == "MAGIC":
                c["magic"] = _bytes_str(const_value(stmt.value))
                where["codec.magic"] = loc
            elif name == "WIRE_VERSION":
                c["wire_version"] = const_value(stmt.value)
                where["codec.wire_version"] = loc
            elif name.startswith("MSG_"):
                value = _try_const(stmt.value)
                if value is not None:
                    c["messages"][name] = value
                    where[f"codec.messages.{name}"] = loc
            elif name == "_MAX_SECTIONS":
                c["max_sections"] = const_value(stmt.value)
                where["codec.max_sections"] = loc
            elif name in ("REQUEST_OPS", "CALIBRATE_MODES"):
                key = name.lower()
                c[key] = list(const_value(stmt.value))
                where[f"codec.{key}"] = loc
            elif name == "_HEADER":
                fmt = _struct_format(stmt)
                if fmt:
                    c["header_format"] = fmt
                    where["codec.header_format"] = loc
            elif name == "_SECTION":
                fmt = _struct_format(stmt)
                if fmt:
                    c["section_format"] = fmt
                    where["codec.section_format"] = loc
        # the section-tag universe: every 4-byte bytes literal in the
        # codec except the magic itself (tags are used inline at the
        # _pack call sites, not declared as named constants)
        magic = c.get("magic", "").encode("latin-1")
        tags = {n.value for n in ast.walk(codec)
                if isinstance(n, ast.Constant)
                and isinstance(n.value, bytes)
                and len(n.value) == 4 and n.value != magic}
        c["section_tags"] = sorted(_bytes_str(t) for t in tags)
        where["codec.section_tags"] = (CODEC_REL, 1)

    framing = project.tree(FRAMING_REL)
    if framing is not None:
        f = schema["framing"]
        f["ops"] = {}
        f["flags"] = {}
        for stmt in iter_module_scope(framing):
            name = _assign_name(stmt)
            if name is None:
                continue
            loc = (FRAMING_REL, stmt.lineno)
            if name == "BIN_MAGIC":
                f["magic"] = _bytes_str(const_value(stmt.value))
                where["framing.magic"] = loc
            elif name == "MAX_FRAME_BYTES":
                f["max_frame_bytes"] = const_value(stmt.value)
                where["framing.max_frame_bytes"] = loc
            elif name == "HEADER":
                fmt = _struct_format(stmt)
                if fmt:
                    f["header_format"] = fmt
                    where["framing.header_format"] = loc
            elif name.startswith("OP_"):
                value = _try_const(stmt.value)
                if value is not None:
                    f["ops"][name] = value
                    where[f"framing.ops.{name}"] = loc
            elif name.startswith("FLAG_"):
                value = _try_const(stmt.value)
                if value is not None:
                    f["flags"][name] = value
                    where[f"framing.flags.{name}"] = loc
    return schema, where


def write_lock(project_root: str, schema: Dict) -> str:
    path = os.path.join(project_root, LOCK_REL)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(schema, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


_BREAKING_HINT = ("this is a breaking wire change — old payloads stop "
                  "decoding; bump WIRE_VERSION, keep the old decode path "
                  "(the v1->v2 checksum precedent), then refresh the lock "
                  "with --update-wire-lock")
_ADDITIVE_HINT = ("new wire surface — review it, then refresh the lock: "
                  "python -m repro_torch.analysis --update-wire-lock")


@register
class WireDriftRule(Rule):
    id = "WIRE-DRIFT"
    hint = _BREAKING_HINT

    def finalize(self, project: Project) -> Iterable[Finding]:
        schema, where = extract_schema(project)
        raw = project.read(LOCK_REL)
        if raw is None:
            return [self.finding(
                LOCK_REL, 1,
                "wire schema lock is missing — the wire surface has no "
                "reviewed source of truth", hint=_ADDITIVE_HINT)]
        try:
            lock = json.loads(raw)
        except ValueError as e:
            return [self.finding(
                LOCK_REL, 1, f"wire schema lock is not valid JSON: {e}",
                hint=_ADDITIVE_HINT)]
        out: List[Finding] = []
        for side in ("codec", "framing"):
            self._diff_side(side, schema.get(side, {}),
                            lock.get(side, {}), where, out)
        return out

    # -- diffing -----------------------------------------------------------
    def _loc(self, where: Dict, key: str, side: str) -> Tuple[str, int]:
        default = CODEC_REL if side == "codec" else FRAMING_REL
        return where.get(key, (default, 1))

    def _diff_side(self, side: str, cur: Dict, locked: Dict,
                   where: Dict, out: List[Finding]) -> None:
        for key in sorted(set(cur) | set(locked)):
            path = f"{side}.{key}"
            rel, line = self._loc(where, path, side)
            if key in _ADDITIVE_MAPS:
                self._diff_map(side, key, cur.get(key, {}),
                               locked.get(key, {}), where, out)
            elif key in _ADDITIVE_LISTS:
                self._diff_list(path, rel, line, cur.get(key, []),
                                locked.get(key, []), out)
            elif key not in locked:
                out.append(self.finding(
                    rel, line,
                    f"wire constant {path} = {cur[key]!r} is not in the "
                    f"committed lock", hint=_ADDITIVE_HINT))
            elif key not in cur:
                out.append(self.finding(
                    rel, line,
                    f"wire constant {path} (locked {locked[key]!r}) no "
                    f"longer exists in the source"))
            elif cur[key] != locked[key]:
                out.append(self.finding(
                    rel, line,
                    f"wire constant {path} changed: locked "
                    f"{locked[key]!r} -> source {cur[key]!r}"))

    def _diff_map(self, side: str, key: str, cur: Dict, locked: Dict,
                  where: Dict, out: List[Finding]) -> None:
        for name in sorted(set(cur) | set(locked)):
            path = f"{side}.{key}.{name}"
            rel, line = self._loc(where, path, side)
            if name not in locked:
                out.append(self.finding(
                    rel, line,
                    f"new wire constant {path} = {cur[name]!r} is not in "
                    f"the committed lock", hint=_ADDITIVE_HINT))
            elif name not in cur:
                out.append(self.finding(
                    rel, line,
                    f"wire constant {path} (locked {locked[name]!r}) was "
                    f"removed — decoders in the field still send it"))
            elif cur[name] != locked[name]:
                out.append(self.finding(
                    rel, line,
                    f"wire constant {path} was renumbered: locked "
                    f"{locked[name]!r} -> source {cur[name]!r}"))

    def _diff_list(self, path: str, rel: str, line: int,
                   cur: List, locked: List, out: List[Finding]) -> None:
        added = sorted(set(cur) - set(locked))
        removed = sorted(set(locked) - set(cur))
        if added:
            out.append(self.finding(
                rel, line,
                f"new entries in {path} not in the committed lock: "
                f"{added}", hint=_ADDITIVE_HINT))
        if removed:
            out.append(self.finding(
                rel, line,
                f"entries removed from {path}: {removed} — old payloads "
                f"referencing them stop decoding"))

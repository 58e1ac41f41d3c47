"""FROZEN-MUT: WorkloadTable columns and wire buffers stay frozen.

The engine's memo cache keys on ``content_token()`` computed from a
table's column bytes; zero-copy wire decode hands out read-only NumPy
views over the receive buffer.  Any in-place mutation of
``table.cols`` / ``table.precision_codes`` / ``table.wclass_codes`` —
or un-freezing a buffer with ``setflags(write=True)`` /
``.flags.writeable = True`` — can serve a *stale cached answer for
different data*, the exact bug PR 5's review rounds chased (writable
receive buffers staling the memo cache).

Flagged shapes:

* ``x.cols[...] = v`` / ``x.cols[...] += v`` — item store or augmented
  assign through a frozen column attribute (any depth of chaining);
* ``x.cols += v`` — augmented assign rebinding through the attribute;
* ``<chain containing .cols>.flags.writeable = True`` — un-freezing;
* ``anything.setflags(write=True)`` — un-freezing any array (wire
  decode views included), frozen attribute or not;
* ``x.cols.resize(...)`` — in-place reshape of a frozen column.

Freezing (``writeable = False``) and writes to *local* arrays still
being built (bare ``cols[...] = ...`` before the table is constructed)
are fine and not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from ..astutil import attr_chain
from ..core import Finding, Module, Rule, register

FROZEN_ATTRS = frozenset({"cols", "precision_codes", "wclass_codes"})


def _through_frozen(node: ast.AST) -> bool:
    """True when the expression dereferences one of the frozen column
    *attributes* (``table.cols``...), as opposed to a bare local name."""
    chain = attr_chain(node)
    return any(a in FROZEN_ATTRS for a in chain[1:])


@register
class FrozenMutRule(Rule):
    id = "FROZEN-MUT"
    hint = ("WorkloadTable columns are frozen — the memo cache keys on "
            "their content; build a new table (take/concat/from_workloads)"
            " instead of mutating, and never un-freeze a wire-decoded "
            "buffer")

    def visit(self, module: Module) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    self._check_store(module, node, target, out)
            elif isinstance(node, ast.AugAssign):
                self._check_store(module, node, node.target, out,
                                  augmented=True)
            elif isinstance(node, ast.Call):
                self._check_call(module, node, out)
        return out

    def _check_store(self, module: Module, stmt: ast.stmt,
                     target: ast.AST, out: List[Finding],
                     augmented: bool = False) -> None:
        if isinstance(target, ast.Subscript) \
                and _through_frozen(target.value):
            what = "augmented assign into" if augmented else "store into"
            out.append(self.finding(
                module.rel, stmt.lineno,
                f"in-place {what} a frozen WorkloadTable column "
                f"({'.'.join(attr_chain(target.value)[-2:])}[...])"))
        elif isinstance(target, ast.Attribute) \
                and target.attr == "writeable" \
                and _through_frozen(target) \
                and isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Constant) \
                and stmt.value.value is True:
            out.append(self.finding(
                module.rel, stmt.lineno,
                "un-freezing a WorkloadTable column "
                "(.flags.writeable = True)"))
        elif isinstance(target, ast.Attribute) \
                and target.attr in FROZEN_ATTRS and not augmented \
                and attr_chain(target)[:1] != ["self"]:
            # rebinding table.cols = ... wholesale replaces the frozen
            # array behind a possibly-interned content token (self.cols
            # assignments are constructors initializing their own table)
            out.append(self.finding(
                module.rel, stmt.lineno,
                f"rebinding .{target.attr} on a live table — the cached "
                f"content token no longer matches the data"))

    def _check_call(self, module: Module, call: ast.Call,
                    out: List[Finding]) -> None:
        if not isinstance(call.func, ast.Attribute):
            return
        attr = call.func.attr
        if attr == "setflags":
            write_true = any(
                kw.arg == "write" and isinstance(kw.value, ast.Constant)
                and kw.value.value for kw in call.keywords)
            if write_true:
                out.append(self.finding(
                    module.rel, call.lineno,
                    "setflags(write=True) un-freezes a buffer — decoded "
                    "wire views and table columns must stay read-only"))
        elif attr == "resize" and _through_frozen(call.func.value):
            out.append(self.finding(
                module.rel, call.lineno,
                "in-place resize of a frozen WorkloadTable column"))

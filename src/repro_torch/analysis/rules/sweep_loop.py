"""SWEEP-LOOP: sweeps are WorkloadTables, never per-config loops.

The sweep-construction contract (ROADMAP "Standing contracts"): a sweep
is a ``WorkloadTable`` (or a lazy ``LatticeSpec``) priced through the
columnar ``predict_table``/``argmin_table``/``*_stream`` routes.
Constructing one ``Workload`` per configuration — or calling the scalar
``predict()`` once per configuration — inside a loop or comprehension
rebuilds the 21.6k-cfg/s scalar path the columnar engine replaced
(~1.4M cfg/s cold, PR 2) and bypasses the memo cache's content tokens.

Allow-listed files may loop: the suite inventories
(``core/suites/``) build a handful of *named* kernels for measurement —
those are characterization lists, not sweeps.  Everything else needs an
inline justification, e.g. the CDNA3 scalar-fallback rows (hit-rate /
Eq. 10 walks) that are priced per row by design, or the device
microbenchmark harness's two characterization loops
(``core/microbench.py``).
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from ..astutil import attr_chain
from ..core import Finding, Module, Rule, register

#: files whose per-config loops are characterization inventories, not
#: sweeps (relative-path substrings)
ALLOWED_PATHS = (
    "repro_torch/core/suites/",
)

_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


@register
class SweepLoopRule(Rule):
    id = "SWEEP-LOOP"
    hint = ("build the whole sweep as a WorkloadTable (tile_lattice / "
            "cartesian / from_workloads) or a LatticeSpec and price it "
            "via predict_table / argmin_table / *_stream; scalar "
            "predict() is for one-off questions only")

    def visit(self, module: Module) -> Iterable[Finding]:
        if any(a in module.rel for a in ALLOWED_PATHS):
            return ()
        out: List[Finding] = []
        self._scan(module, module.tree, 0, out)
        return out

    def _scan(self, module: Module, node: ast.AST, depth: int,
              out: List[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            d = depth + 1 if isinstance(child, _LOOPS) else depth
            if depth and isinstance(child, ast.Call):
                self._check_call(module, child, out)
            self._scan(module, child, d, out)

    def _check_call(self, module: Module, call: ast.Call,
                    out: List[Finding]) -> None:
        chain = attr_chain(call.func)
        if not chain:
            return
        name = chain[-1]
        if name == "Workload":
            out.append(self.finding(
                module.rel, call.lineno,
                "per-config Workload construction inside a loop/"
                "comprehension (the sweep-construction contract)"))
        elif name == "predict":
            out.append(self.finding(
                module.rel, call.lineno,
                "scalar predict() inside a loop/comprehension — this is "
                "the per-config path the columnar engine replaced"))

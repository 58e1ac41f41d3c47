"""METRIC-NAME: metric families and labels come from closed sets.

The exposition contract (serve/README.md, enforced at runtime by
``tests/test_torch_obs.py``): every family matches
``repro_{serve,client,sweep,pool}_*``, label keys come from a small
closed vocabulary, and the family inventory is append-only —
dashboards and scrapers bind to these names, so a silent rename is a
breaking API change that no unit test of the renamed code will catch.

Per file, the rule checks every ``counter(...)`` / ``gauge(...)`` /
``histogram(...)`` call:

* the family (first argument) must be a **string literal** — a computed
  name cannot be checked against the contract, and the registry's
  append-only test can't see it either;
* the literal must match ``repro_(serve|client|sweep|pool)_[a-z0-9_]+``;
* every label kwarg key must be in the closed label vocabulary, and a
  *literal* label value must be in that key's closed value set.

Cross-file (``finalize``): the set of literal families registered in
``src/repro_torch`` is reconciled with ``EXPECTED_FAMILIES`` in
``tests/test_torch_obs.py`` in both directions — a new family missing from
the list fails (append it), and a listed family with no remaining call
site fails (exposition is append-only; restore it).

``repro_torch/obs/metrics.py`` itself is exempt: its module-level
``counter(name, ...)`` wrappers forward caller-supplied names.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Tuple

from ..astutil import attr_chain, const_value
from ..core import Finding, Module, Project, Rule, register

FAMILY_RE = re.compile(r"^repro_(serve|client|sweep|pool)_[a-z0-9_]+$")

#: closed label vocabulary: key -> allowed literal values
LABEL_VALUES: Dict[str, frozenset] = {
    "transport": frozenset({"http", "binary"}),
    "stage": frozenset({"parse", "queue_wait", "fuse", "evaluate",
                        "encode", "write"}),
    "reason": frozenset({"overload", "deadline"}),
    "cache": frozenset({"hit", "miss"}),
}

#: kwargs of the registration helpers that are not labels
_NON_LABEL_KWARGS = {"help", "buckets"}

_REGISTER_NAMES = {"counter", "gauge", "histogram"}

EXEMPT_PATHS = ("repro_torch/obs/metrics.py",)

CONTRACT_TEST_REL = "tests/test_torch_obs.py"


@register
class MetricNameRule(Rule):
    id = "METRIC-NAME"
    hint = ("metric families follow repro_{serve,client,sweep,pool}_* "
            "with label keys from the closed vocabulary "
            "(transport/stage/reason/cache); the family inventory is "
            "append-only — see tests/test_torch_obs.py EXPECTED_FAMILIES")

    def __init__(self):
        #: family -> first registration site, for the finalize check
        self.declared: Dict[str, Tuple[str, int]] = {}

    def visit(self, module: Module) -> Iterable[Finding]:
        if any(e in module.rel for e in EXEMPT_PATHS):
            return ()
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] not in _REGISTER_NAMES:
                continue
            self._check_register(module, node, out)
        return out

    def _check_register(self, module: Module, call: ast.Call,
                        out: List[Finding]) -> None:
        if not call.args:
            return
        name_arg = call.args[0]
        if isinstance(name_arg, ast.Constant) \
                and isinstance(name_arg.value, str):
            family = name_arg.value
            if not FAMILY_RE.match(family):
                out.append(self.finding(
                    module.rel, call.lineno,
                    f"metric family {family!r} is outside the "
                    f"repro_{{serve,client,sweep,pool}}_* namespace"))
            else:
                self.declared.setdefault(
                    family, (module.rel, call.lineno))
        else:
            out.append(self.finding(
                module.rel, call.lineno,
                "metric family name is not a string literal — a computed "
                "name cannot be checked against the exposition contract"))
        for kw in call.keywords:
            if kw.arg is None or kw.arg in _NON_LABEL_KWARGS:
                continue
            if kw.arg not in LABEL_VALUES:
                out.append(self.finding(
                    module.rel, call.lineno,
                    f"label key {kw.arg!r} is outside the closed label "
                    f"vocabulary {sorted(LABEL_VALUES)}"))
            elif isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str) \
                    and kw.value.value not in LABEL_VALUES[kw.arg]:
                out.append(self.finding(
                    module.rel, call.lineno,
                    f"label {kw.arg}={kw.value.value!r} is outside the "
                    f"closed value set "
                    f"{sorted(LABEL_VALUES[kw.arg])}"))

    # -- cross-file: reconcile with the append-only contract list ----------
    def finalize(self, project: Project) -> Iterable[Finding]:
        tree = project.tree(CONTRACT_TEST_REL)
        if tree is None:
            return [self.finding(
                CONTRACT_TEST_REL, 1,
                "metric contract test is missing — EXPECTED_FAMILIES is "
                "the append-only family inventory", severity="warning")]
        expected: Dict[str, int] = {}
        list_line = 1
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "EXPECTED_FAMILIES"
                    for t in node.targets):
                list_line = node.lineno
                try:
                    for elt, value in zip(node.value.elts,
                                          const_value(node.value)):
                        expected[value] = elt.lineno
                except (ValueError, AttributeError):
                    pass
                break
        out: List[Finding] = []
        for family, (rel, line) in sorted(self.declared.items()):
            if family not in expected:
                out.append(self.finding(
                    rel, line,
                    f"metric family {family!r} is not in "
                    f"{CONTRACT_TEST_REL} EXPECTED_FAMILIES — append it "
                    f"(the inventory is append-only)"))
        for family, line in sorted(expected.items()):
            if family not in self.declared:
                out.append(self.finding(
                    CONTRACT_TEST_REL, line or list_line,
                    f"contract family {family!r} has no registration "
                    f"site left in src/repro_torch — exposition is "
                    f"append-only; restore the family"))
        return out

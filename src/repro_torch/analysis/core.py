"""Contract-linter framework: AST rules, suppressions, repo driver.

The repo's standing contracts (ROADMAP "Standing contracts") are
runtime-enforced by tests and benchmark bit-identity flags — which fire
*after* a violation ships.  This package is the diff-time half: a
stdlib-only (``ast`` + ``tokenize``) static pass that recognizes the
contract-violating *shapes* in source code and fails the gate before
anything runs.  PPT-GPU's static pre-characterization pass (see
SNIPPETS.md) is the model: task structure is extractable from source
without executing it.

Pieces:

* :class:`Rule` — one contract, registered by subclassing with
  ``@register``.  ``visit(module)`` yields findings per file;
  ``finalize(project)`` runs once for cross-file contracts (metric
  family inventories, wire-schema locks).
* :class:`Finding` — ``file:line``, rule id, message, a one-line fix
  hint, and a per-rule severity (``error`` gates, ``warning`` reports).
* Suppressions — ``# repro: allow[RULE-ID] <justification>`` on the
  offending line (or a standalone comment directly above it).  The
  justification is REQUIRED: a bare allow is itself an error finding
  (``SUPPRESS``), and the underlying finding still gates.  Unused
  suppressions are warnings (``SUPPRESS-UNUSED``) so stale allows rot
  visibly.
* :func:`run_checks` — the driver ``python -m repro_torch.analysis``
  and the tier-1 test both call.

Adding a rule: subclass :class:`Rule` in ``rules/``, decorate with
``@register``, import the module from ``rules/__init__``.  See
``README.md`` in this package.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "ERROR", "WARNING", "Finding", "Module", "Project", "Report", "Rule",
    "RULES", "DEFAULT_PATHS", "register", "repo_root", "run_checks",
]

ERROR = "error"
WARNING = "warning"

#: what the gate lints by default, relative to the repo root
DEFAULT_PATHS: Tuple[str, ...] = ("src/repro_torch",)

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*allow\[([A-Za-z0-9_-]+)\]\s*(.*?)\s*$")


@dataclass(frozen=True)
class Finding:
    """One contract violation (or meta finding) at ``path:line``."""

    rule: str
    path: str            # repo-relative, posix separators
    line: int
    message: str
    hint: str = ""
    severity: str = ERROR
    suppressed: bool = False
    justification: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "hint": self.hint,
            "severity": self.severity, "suppressed": self.suppressed,
            "justification": self.justification,
        }

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        out = (f"{self.location}: [{self.rule}] {self.severity}{tag}: "
               f"{self.message}")
        if self.hint and not self.suppressed:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Suppression:
    """One ``# repro: allow[ID] why`` comment."""

    line: int            # line the comment sits on
    target: int          # code line it suppresses
    rule: str
    justification: str
    used: bool = False


class Module:
    """One parsed source file plus its suppression comments."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(source, filename=rel)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        self.suppressions: List[Suppression] = self._scan_suppressions()

    # -- suppressions ------------------------------------------------------
    def _scan_suppressions(self) -> List[Suppression]:
        out: List[Suppression] = []
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                line = tok.start[0]
                standalone = not self.lines[line - 1][:tok.start[1]].strip()
                out.append(Suppression(
                    line=line,
                    target=self._next_code_line(line) if standalone
                    else line,
                    rule=m.group(1), justification=m.group(2)))
        except tokenize.TokenError:
            pass                     # the PARSE finding covers broken files
        return out

    def _next_code_line(self, after: int) -> int:
        """First line past ``after`` holding code (a standalone allow
        comment suppresses the statement it stands above)."""
        for i in range(after, len(self.lines)):
            text = self.lines[i].strip()
            if text and not text.startswith("#"):
                return i + 1
        return after


class Project:
    """The file set one run lints, plus read access to the whole repo
    (cross-file rules read committed artifacts like lock files and the
    metric-contract test even when those are outside the linted paths)."""

    def __init__(self, root: str, modules: Sequence[Module]):
        self.root = root
        self.modules = list(modules)
        self._by_rel = {m.rel: m for m in self.modules}

    def module(self, rel: str) -> Optional[Module]:
        return self._by_rel.get(rel.replace(os.sep, "/"))

    def read(self, rel: str) -> Optional[str]:
        """Source of any repo file (linted or not); None if absent."""
        m = self.module(rel)
        if m is not None:
            return m.source
        path = os.path.join(self.root, rel)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    def tree(self, rel: str) -> Optional[ast.AST]:
        m = self.module(rel)
        if m is not None:
            return m.tree
        src = self.read(rel)
        if src is None:
            return None
        try:
            return ast.parse(src, filename=rel)
        except SyntaxError:
            return None


class Rule:
    """One standing contract.  Subclass, set ``id``/``hint``/``severity``,
    implement ``visit`` (per file) and/or ``finalize`` (once, cross-file),
    and decorate with :func:`register`."""

    id: str = ""
    severity: str = ERROR
    hint: str = ""

    def visit(self, module: Module) -> Iterable[Finding]:
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        return ()

    # -- helpers -----------------------------------------------------------
    def finding(self, rel: str, line: int, message: str, *,
                hint: Optional[str] = None,
                severity: Optional[str] = None) -> Finding:
        return Finding(
            rule=self.id, path=rel, line=int(line), message=message,
            hint=self.hint if hint is None else hint,
            severity=self.severity if severity is None else severity)


#: rule id -> rule class; populated by ``@register`` at import of
#: ``repro_torch.analysis.rules``
RULES: Dict[str, type] = {}


def register(cls):
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in RULES and RULES[cls.id] is not cls:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    RULES[cls.id] = cls
    return cls


def repo_root() -> str:
    """The checkout this installed package belongs to
    (``src/repro_torch/analysis/core.py`` -> four levels up)."""
    here = os.path.abspath(__file__)
    root = here
    for _ in range(4):
        root = os.path.dirname(root)
    return root


def collect_modules(root: str, paths: Sequence[str]) -> List[Module]:
    files: List[str] = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            files.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            files.extend(os.path.join(dirpath, fn)
                         for fn in sorted(filenames) if fn.endswith(".py"))
    modules = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        modules.append(Module(path, rel, source))
    return modules


@dataclass
class Report:
    """Every finding of one run, suppressions already resolved."""

    findings: List[Finding] = field(default_factory=list)

    def unsuppressed(self, severity: Optional[str] = None) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed
                and (severity is None or f.severity == severity)]

    @property
    def errors(self) -> List[Finding]:
        return self.unsuppressed(ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> Dict:
        return {
            "ok": self.ok,
            "counts": {
                "errors": len(self.errors),
                "warnings": len(self.unsuppressed(WARNING)),
                "suppressed": sum(1 for f in self.findings
                                  if f.suppressed),
            },
            "findings": [f.to_dict() for f in self.findings],
        }

    def render(self, verbose: bool = True) -> str:
        shown = self.findings if verbose else self.unsuppressed()
        return "\n".join(f.render() for f in shown)


def _load_baseline(path: Optional[str]) -> List[Dict]:
    if not path:
        return []
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("findings", doc) if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a findings list")
    return entries


def _apply_suppressions(findings: List[Finding],
                        modules: Sequence[Module],
                        baseline: List[Dict]) -> List[Finding]:
    by_rel: Dict[str, List[Suppression]] = {}
    meta: List[Finding] = []
    for m in modules:
        live = []
        for s in m.suppressions:
            if not s.justification:
                meta.append(Finding(
                    rule="SUPPRESS", path=m.rel, line=s.line,
                    message=(f"suppression of {s.rule} carries no "
                             f"justification — the allow is inert"),
                    hint=("write '# repro: allow[{0}] <why this is "
                          "safe>'".format(s.rule))))
                continue
            live.append(s)
        by_rel[m.rel] = live

    base_keys = {(e.get("rule"), e.get("path"), int(e.get("line", 0)))
                 for e in baseline}
    out: List[Finding] = []
    for f in findings:
        supp = next(
            (s for s in by_rel.get(f.path, ())
             if s.rule == f.rule and s.target == f.line), None)
        if supp is not None:
            supp.used = True
            out.append(replace(f, suppressed=True,
                               justification=supp.justification))
        elif (f.rule, f.path, f.line) in base_keys:
            out.append(replace(f, suppressed=True,
                               justification="grandfathered by baseline"))
        else:
            out.append(f)

    for m in modules:
        for s in by_rel.get(m.rel, ()):
            if not s.used:
                meta.append(Finding(
                    rule="SUPPRESS-UNUSED", path=m.rel, line=s.line,
                    severity=WARNING,
                    message=(f"suppression of {s.rule} matches no "
                             f"finding — delete the stale allow")))
    return out + meta


def run_checks(root: Optional[str] = None,
               paths: Optional[Sequence[str]] = None,
               rules: Optional[Sequence[str]] = None,
               baseline: Optional[str] = None) -> Report:
    """Lint ``paths`` (default ``src/repro_torch``) under ``root`` (default:
    this checkout) with ``rules`` (default: all registered).  Returns a
    :class:`Report`; the run gates on ``report.errors``."""
    from . import rules as _rules_pkg                      # noqa: F401
    root = os.path.abspath(root or repo_root())
    modules = collect_modules(root, paths or DEFAULT_PATHS)
    project = Project(root, modules)
    active = [RULES[r]() for r in rules] if rules is not None \
        else [cls() for _, cls in sorted(RULES.items())]

    findings: List[Finding] = []
    for m in modules:
        if m.parse_error is not None:
            findings.append(Finding(
                rule="PARSE", path=m.rel,
                line=m.parse_error.lineno or 1,
                message=f"file does not parse: {m.parse_error.msg}"))
            continue
        for rule in active:
            findings.extend(rule.visit(m))
    for rule in active:
        findings.extend(rule.finalize(project))

    findings = _apply_suppressions(
        findings, modules, _load_baseline(baseline))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings)

"""FORK-LOCK: module-lifetime locks need an at-fork re-init hook.

``fork()`` clones exactly one thread.  A ``threading.Lock`` held by any
*other* thread at fork time is copied in the locked state and nobody in
the child will ever release it — the child deadlocks on first use.
The repo forks deliberately (``core/parallel.py`` worker pools prefer
fork for COW) so every lock that lives as long as the module must be
re-initialized in the child: ``os.register_at_fork(after_in_child=...)``
(the pattern ``core/sweep.py`` / ``obs/metrics.py`` / ``obs/trace.py``
established).

Flagged shapes, in any module without its own ``register_at_fork``
call:

* a module-scope ``threading.Lock()`` / ``RLock()`` assignment;
* a module-scope *singleton* of a class whose methods stash a lock on
  ``self`` (``REGISTRY = _LazyRegistry()`` with ``self._lock =
  threading.RLock()`` in ``__init__`` — the lock's lifetime is the
  module's even though the call site is a method).

Instance locks on short-lived objects (per-connection, per-pool) are
NOT flagged: ``core/parallel.py`` holds locks only on ``WorkerPool``
instances and refuses the fork start method outright once any helper
thread is alive (``_mp_context``/``allow_fork=False``), so its
fork-safety hook legitimately lives with the engine caches in
``core/sweep.py`` — audited for ISSUE 10, no module-lifetime lock
there.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..astutil import attr_chain, iter_module_scope
from ..core import Finding, Module, Rule, register

_LOCK_NAMES = {"Lock", "RLock"}


def _is_lock_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return bool(chain) and chain[-1] in _LOCK_NAMES


def _has_fork_hook(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] == "register_at_fork":
                return True
    return False


def _lock_holding_classes(tree: ast.AST) -> Set[str]:
    """Class names whose methods assign a lock onto ``self``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _is_lock_call(sub.value) \
                    and any(isinstance(t, ast.Attribute)
                            and attr_chain(t)[:1] == ["self"]
                            for t in sub.targets):
                out.add(node.name)
                break
    return out


@register
class ForkLockRule(Rule):
    id = "FORK-LOCK"
    hint = ("re-initialize the lock in a fork hook: os.register_at_fork("
            "after_in_child=lambda: ...) in this module, mirroring "
            "core/sweep.py / obs/metrics.py")

    def visit(self, module: Module) -> Iterable[Finding]:
        tree = module.tree
        if _has_fork_hook(tree):
            return ()
        out: List[Finding] = []
        singletons = _lock_holding_classes(tree)
        for stmt in iter_module_scope(tree):
            if isinstance(stmt, ast.AnnAssign):        # X: T = Lock()
                if stmt.value is None:
                    continue
            elif not isinstance(stmt, ast.Assign):
                continue
            if _is_lock_call(stmt.value):
                out.append(self.finding(
                    module.rel, stmt.lineno,
                    "module-level threading lock in a module without an "
                    "os.register_at_fork re-init hook — a forked child "
                    "can inherit it locked"))
            elif isinstance(stmt.value, ast.Call):
                chain = attr_chain(stmt.value.func)
                if chain and chain[-1] in singletons:
                    out.append(self.finding(
                        module.rel, stmt.lineno,
                        f"module-scope singleton of lock-holding class "
                        f"{chain[-1]} in a module without an "
                        f"os.register_at_fork re-init hook — its lock "
                        f"lives as long as the module"))
        return out

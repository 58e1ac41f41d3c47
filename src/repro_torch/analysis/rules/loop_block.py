"""LOOP-BLOCK: the binserver event loop must never block.

``serve/binserver.py`` runs ONE ``selectors`` thread for every binary
connection: accept, read, parse, write — nothing else.  A single
blocking call reachable from that thread stalls every pipelined client
at once (the transport's ~190x win over HTTP exists precisely because
nothing on the loop waits).  Real evaluation belongs in the coalescer
(``submit_async``) or the slow pool.

The rule builds an intra-module call graph from the configured entry
points (``_loop``) — ``self.method()`` and module-function edges — and
flags blocking primitives in any reachable function:

* ``time.sleep``, ``open()``, ``os.system``, ``subprocess.*``,
  ``socket.create_connection``;
* ``.sendall()`` / ``.makefile()`` (the loop buffers and uses
  nonblocking ``send``);
* ``.acquire()`` / ``.join()`` / ``.result()`` / ``.wait()`` without a
  timeout, and zero-argument ``.get()`` (queue-style indefinite wait).

Functions merely *defined* inside reachable code (completion callbacks
like ``on_done``) run on other threads and are not scanned.
``with lock:`` is deliberately allowed: bounded critical sections are
the stats-snapshot pattern; an *indefinite* ``acquire()`` is not.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from ..astutil import call_name
from ..core import Finding, Module, Rule, register

#: event-loop modules (relative-path substring) -> entry-point function
#: names whose transitive intra-module callees must not block
EVENT_LOOP_FILES: Dict[str, Tuple[str, ...]] = {
    "repro_torch/serve/binserver.py": ("_loop",),
}

#: (qualifier, name) calls that always block
_BLOCKING_CALLS = {
    ("time", "sleep"), ("os", "system"),
    ("socket", "create_connection"),
}
_BLOCKING_BARE = {"open", "input"}
_BLOCKING_QUALIFIER_PREFIX = ("subprocess",)
#: method names that block regardless of arguments
_BLOCKING_METHODS = {"sendall", "makefile"}
#: method names that block indefinitely unless given a timeout
_TIMEOUT_METHODS = {"acquire", "join", "result", "wait"}


def _has_timeout(call: ast.Call) -> bool:
    if call.args:                    # positional timeout (acquire/join)
        return True
    return any(kw.arg in ("timeout", "blocking", "block")
               for kw in call.keywords)


class _FnScanner(ast.NodeVisitor):
    """Calls made by one function body, not descending into nested
    function/lambda definitions (those run on other threads)."""

    def __init__(self):
        self.calls: List[ast.Call] = []

    def visit_FunctionDef(self, node):     # nested defs: skip bodies
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_Call(self, node: ast.Call):
        self.calls.append(node)
        self.generic_visit(node)


def _function_calls(fn: ast.AST) -> List[ast.Call]:
    scanner = _FnScanner()
    for stmt in fn.body:
        scanner.visit(stmt)
    return scanner.calls


@register
class LoopBlockRule(Rule):
    id = "LOOP-BLOCK"
    hint = ("the event loop must never wait: dispatch through the "
            "coalescer's submit_async or the slow pool, use nonblocking "
            "socket ops, or bound the call with a timeout")

    def visit(self, module: Module) -> Iterable[Finding]:
        entries = next(
            (names for sub, names in EVENT_LOOP_FILES.items()
             if sub in module.rel), None)
        if entries is None:
            return ()

        # name -> defs (methods of any class + module functions; an
        # intra-module approximation — self.x() resolves by method name)
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)

        # BFS over call edges, remembering one path for the report
        via: Dict[str, Tuple[str, ...]] = {}
        queue: List[str] = []
        for name in entries:
            if name in defs:
                via[name] = (name,)
                queue.append(name)
        out: List[Finding] = []
        while queue:
            name = queue.pop(0)
            for fn in defs[name]:
                for call in _function_calls(fn):
                    qual, callee = call_name(call)
                    self._check_blocking(module, call, qual, callee,
                                         via[name], out)
                    if callee in defs and callee not in via \
                            and (qual is None or qual == "self"):
                        via[callee] = via[name] + (callee,)
                        queue.append(callee)
        return out

    def _check_blocking(self, module: Module, call: ast.Call,
                        qual: Optional[str], name: str,
                        path: Tuple[str, ...],
                        out: List[Finding]) -> None:
        route = " -> ".join(path)
        blocked = None
        if (qual, name) in _BLOCKING_CALLS \
                or (qual is None and name in _BLOCKING_BARE) \
                or (qual or "").startswith(_BLOCKING_QUALIFIER_PREFIX):
            blocked = f"{qual + '.' if qual else ''}{name}()"
        elif qual is not None and name in _BLOCKING_METHODS:
            blocked = f".{name}() (use nonblocking send + output buffer)"
        elif qual is not None and name in _TIMEOUT_METHODS \
                and not _has_timeout(call):
            blocked = f".{name}() without a timeout"
        elif qual is not None and name == "get" and not call.args \
                and not call.keywords:
            blocked = ".get() with no arguments (indefinite queue wait)"
        if blocked:
            out.append(self.finding(
                module.rel, call.lineno,
                f"blocking call {blocked} reachable from the event loop "
                f"(via {route})"))

"""Small shared AST helpers for the contract rules (stdlib only)."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

__all__ = ["attr_chain", "call_name", "const_value", "iter_module_scope"]


def attr_chain(node: ast.AST) -> List[str]:
    """Attribute/name path of an expression, outermost last.

    ``table.cols[i].flags.writeable`` -> ``["table", "cols", "flags",
    "writeable"]`` (subscripts and calls are transparent).  Unresolvable
    roots (calls of calls, literals) contribute nothing.
    """
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, (ast.Subscript, ast.Call)):
            node = node.func if isinstance(node, ast.Call) else node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            break
    parts.reverse()
    return parts


def call_name(call: ast.Call) -> Tuple[Optional[str], str]:
    """(qualifier, name) of a call: ``time.sleep(...)`` ->
    ``("time", "sleep")``, ``open(...)`` -> ``(None, "open")``,
    ``self._flush(...)`` -> ``("self", "_flush")``.  The qualifier is the
    full dotted prefix."""
    chain = attr_chain(call.func)
    if not chain:
        return None, ""
    if len(chain) == 1:
        return None, chain[0]
    return ".".join(chain[:-1]), chain[-1]


def const_value(node: ast.AST):
    """Fold a constant expression (literals, tuples/lists of constants,
    +-*//<< on folded values, unary minus).  Raises ValueError when the
    expression is not statically constant."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        return [const_value(e) for e in node.elts]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -const_value(node.operand)
    if isinstance(node, ast.BinOp):
        left, right = const_value(node.left), const_value(node.right)
        op = type(node.op)
        folds = {ast.Add: lambda a, b: a + b,
                 ast.Sub: lambda a, b: a - b,
                 ast.Mult: lambda a, b: a * b,
                 ast.Pow: lambda a, b: a ** b,
                 ast.LShift: lambda a, b: a << b,
                 ast.RShift: lambda a, b: a >> b,
                 ast.BitOr: lambda a, b: a | b,
                 ast.FloorDiv: lambda a, b: a // b}
        if op in folds:
            return folds[op](left, right)
    raise ValueError(f"not a static constant: {ast.dump(node)}")


def iter_module_scope(tree: ast.Module) -> Iterator[ast.stmt]:
    """Statements executed at import time at module scope — walks into
    module-level ``if``/``try``/``with`` blocks but never into function
    or class bodies."""
    stack: List[ast.stmt] = list(tree.body)
    while stack:
        stmt = stack.pop(0)
        yield stmt
        if isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                             ast.While)):
            for name in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(stmt, name, ()):
                    if isinstance(child, ast.ExceptHandler):
                        stack.extend(child.body)
                    else:
                        stack.append(child)

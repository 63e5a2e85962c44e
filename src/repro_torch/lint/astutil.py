"""AST helpers shared by the lint rules of the port.

Everything here works on plain ``ast`` trees: the lint never imports
the modules it checks (they need torch, and fixture trees are not
importable at all).  The two workhorses are the import-alias map (so
``np.random.rand``, ``numpy.random.rand`` and ``from numpy import
random; random.rand`` all resolve to one dotted name) and the
literal-constant loader that reads ``kernels/photon_step/spec.py``
without executing it.
"""

from __future__ import annotations

import ast
from typing import Iterator


def build_alias_map(tree: ast.AST, package: str = "") -> dict[str, str]:
    """Map local names to fully-dotted import targets.

    ``import numpy as np``            -> {"np": "numpy"}
    ``import torch.nn.functional as F`` -> {"F": "torch.nn.functional"}
    ``import torch.cuda``             -> {"torch": "torch"}
    ``from numpy import random``      -> {"random": "numpy.random"}
    ``from x import y as z``          -> {"z": "x.y"}
    ``from . import volume`` (in package p) -> {"volume": "p.volume"}

    Collected over the whole tree (function-local imports included) —
    alias resolution is about *naming*, reachability scope is handled
    separately by the import-graph walk.
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    # "import x.y" binds the root package name
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = resolve_from_module(node, package)
            if base is None:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def resolve_from_module(node: ast.ImportFrom, package: str) -> str | None:
    """Absolute module a ``from X import ...`` pulls from, or None."""
    if node.level == 0:
        return node.module
    # relative import: strip (level - 1) trailing components off the
    # importing module's package
    parts = package.split(".") if package else []
    if node.level - 1 > len(parts):
        return None
    base = parts[:len(parts) - (node.level - 1)]
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base) if base else None


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain as a string, or None for non-chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted name with its leading alias expanded (np.x -> numpy.x)."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in aliases:
        return aliases[head] + ("." + rest if rest else "")
    return name


def matches_prefix(name: str, prefixes: tuple[str, ...]) -> str | None:
    """The prefix ``name`` falls under, respecting dot boundaries."""
    for p in prefixes:
        if name == p or name.startswith(p + "."):
            return p
    return None


def load_literal_constants(tree: ast.AST) -> dict[str, object]:
    """Module-level ``NAME = <literal>`` assignments, literal-evaled.

    Used to read the kernel output-spec constants from spec.py without
    importing it; non-literal assignments are silently skipped.
    """
    out: dict[str, object] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except (ValueError, TypeError, SyntaxError):
                pass
    return out


def find_function(tree: ast.AST, name: str) -> ast.FunctionDef | None:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == name:
            return node
    return None


def param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def is_subsequence(sub: tuple[str, ...], seq: list[str]) -> bool:
    it = iter(seq)
    return all(x in it for x in sub)


def test_flag_names(test: ast.AST) -> set[str]:
    """Plain names appearing in an ``if`` test (the guard flags)."""
    return {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}


def literal_env(fn: ast.FunctionDef,
                module_tree: ast.AST | None = None) -> dict[str, ast.AST]:
    """Map of simple single-target assignments visible inside a function.

    Supports constant propagation: ``shape = (60, 60, 60)`` followed by
    ``photon_steps(..., shape, ...)``, including aliases (``shp =
    shape``) via :func:`resolve_literal` / :func:`chase_names`.  When ``module_tree`` is given, module-level
    single assignments seed the environment (``SHAPE = (60, 60, 60)``
    at the top of the file), with function-local bindings shadowing
    them.  Names rebound more than once in a scope are dropped (their
    value at the call site is ambiguous).
    """
    env: dict[str, ast.AST] = {}
    if module_tree is not None:
        seen: set[str] = set()
        for node in getattr(module_tree, "body", []):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name in seen:
                    env.pop(name, None)
                else:
                    seen.add(name)
                    env[name] = node.value
    rebound: set[str] = set()
    local: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in local or name in rebound:
                env.pop(name, None)
                rebound.add(name)
            else:
                local.add(name)
                env[name] = node.value
    return env


def chase_names(node: ast.AST | None, env: dict[str, ast.AST],
                depth: int = 4) -> ast.AST | None:
    """Follow single-assignment ``Name`` bindings to the defining
    expression (``cfg2 = cfg``; ``cfg = SimConfig(...)`` — returns the
    ``SimConfig(...)`` call).  Stops at non-Name nodes, unknown names,
    or the depth cap (self-referential chains)."""
    while depth > 0 and isinstance(node, ast.Name) and node.id in env:
        nxt = env[node.id]
        if nxt is node:
            break
        node = nxt
        depth -= 1
    return node


def resolve_literal(node: ast.AST | None, env: dict[str, ast.AST],
                    _depth: int = 0) -> object:
    """Literal value of an expression, chasing one level of locals.

    Returns the sentinel :data:`UNRESOLVED` when the expression cannot
    be reduced to a Python literal statically.
    """
    if node is None or _depth > 4:
        return UNRESOLVED
    if isinstance(node, ast.Name) and node.id in env:
        return resolve_literal(env[node.id], env, _depth + 1)
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return UNRESOLVED


class _Unresolved:
    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "<unresolved>"


UNRESOLVED = _Unresolved()


def walk_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node

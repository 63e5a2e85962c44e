"""REP401 — jit-hygiene: one host read every few rounds, none in a round.

The reference's rule keeps host syncs out of traced loop bodies; the
port's round loop is Python, so its counterpart keeps the loop's host
reads to one.  Every read of a device value on the host waits for the
device to finish what it was given: the loop reads its condition once
every ``simulator.ROUNDS_PER_READ`` rounds, and on the card a round is
a CUDA graph replayed between reads, which cannot read the host at all.
A second read would drain the device where it should run round after
round while the host issues the next ones.

Inside the round loop (every ``while`` loop in
``simulator.build_round_loop``, and every function nested in it that
the loop calls, directly or through another such function: the round
itself, which a graph captures) the rule flags ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``, ``int()`` or
``bool()`` of anything but a literal, ``print()`` and
``torch.cuda.synchronize()``.  The loop's one host read (its exit test)
carries ``# reprolint: disable=REP401 - why``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint import Context, Finding, Module, Rule
from repro_torch.lint.astutil import find_function, resolve_dotted

# (module, function) whose while loops are rounds
ROUND_LOOPS = (("repro_torch.core.simulator", "build_round_loop"),)

_READ_METHODS = ("item", "tolist", "cpu", "numpy")
_COERCIONS = ("float", "int", "bool")


class HostSyncRule(Rule):
    id = "REP401"
    name = "jit-hygiene"
    severity = "error"
    description = ("a round of the round loop reads the host once: no "
                   ".item()/.tolist()/.cpu()/float()/int()/bool() of a "
                   "tensor or synchronize() but the pragma'd one")

    def applies(self, mod: Module, ctx: Context) -> bool:
        return any(mod.name == m for m, _ in ROUND_LOOPS)

    def check_module(self, mod: Module, ctx: Context) -> Iterator[Finding]:
        for name in (f for m, f in ROUND_LOOPS if m == mod.name):
            fn = find_function(mod.tree, name)
            if fn is None:
                yield ctx.finding(self, mod, None,
                                  f"`{name}` not found: the round loop "
                                  f"this rule checks has moved")
                continue
            for node in _round_nodes(fn):
                what = self._read(node, mod)
                if what:
                    yield ctx.finding(
                        self, mod, node,
                        f"{what} in the round loop of `{name}`: each "
                        f"host read waits for the device; the loop "
                        f"reads the host once every few rounds, a "
                        f"round never")

    @staticmethod
    def _read(node: ast.AST, mod: Module) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _READ_METHODS:
            return f"`.{f.attr}()`"
        if isinstance(f, ast.Name) and f.id in _COERCIONS and node.args \
                and not isinstance(node.args[0], ast.Constant):
            return f"`{f.id}()` of a value"
        if isinstance(f, ast.Name) and f.id == "print":
            return "`print()`"
        if resolve_dotted(f, mod.aliases) == "torch.cuda.synchronize":
            return "`torch.cuda.synchronize()`"
        return None


def _round_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node of ``fn``'s ``while`` loops and of the functions nested
    in ``fn`` that a loop calls by name, directly or through another
    such function; each once."""
    nested = {n.name: n for n in ast.walk(fn) if n is not fn and isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    todo = [n for n in ast.walk(fn) if isinstance(n, ast.While)]
    done: set[int] = set()
    while todo:
        for node in ast.walk(todo.pop()):
            if id(node) in done:
                continue
            done.add(id(node))
            yield node
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id in nested:
                todo.append(nested[node.func.id])

"""REP401 — jit-hygiene: one host read a round.

The reference's rule keeps host syncs out of traced loop bodies; the
port's round loop is Python, so its counterpart keeps the round's host
reads to one.  Every read of a device value on the host waits for the
device to finish what it was given, and the round issues ~180 device
operations that the card should run while the host issues the next
ones: a second read a round doubles the round's synchronisations and
leaves the card idle while the host catches up.

Inside the round loop (every ``while`` loop in
``simulator.build_round_loop``) the rule flags ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``, ``int()`` or
``bool()`` of anything but a literal, ``print()`` and
``torch.cuda.synchronize()``.  The round's one host read (the loop's
exit test) carries ``# reprolint: disable=REP401 - why``.
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
            for loop in (n for n in ast.walk(fn) if isinstance(n, ast.While)):
                for node in ast.walk(loop):
                    what = self._read(node, mod)
                    if what:
                        yield ctx.finding(
                            self, mod, node,
                            f"{what} in the round loop of `{name}`: each "
                            f"host read waits for the device; a round "
                            f"reads the host once")

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

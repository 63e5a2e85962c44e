"""REP601 — reachability: no dead module under src/repro_torch.

A module nothing reaches rots unseen.  This rule computes the import
closure from the port's real entry points and flags every
``repro_torch.*`` module outside it.  Roots: every
``repro_torch.launch.*`` module, ``repro_torch.lint`` itself,
``chip_smoke.py`` and the port's tests (``tests/test_torch_*.py``,
read for their imports only).  Reachability follows every import,
function-level lazy ones included.  A flagged module is deleted, or
wired to a real consumer, not given a pragma.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint import (Context, Finding, Module, Rule, all_imports,
                              reachable_closure)
from repro_torch.lint.astutil import build_alias_map


class ReachabilityRule(Rule):
    id = "REP601"
    name = "reachability"
    severity = "error"
    description = ("every repro_torch module must be importable from a "
                   "CLI entry point, the lint, chip_smoke.py or a port "
                   "test")

    def check(self, ctx: Context) -> Iterator[Finding]:
        roots = [name for name in ctx.modules
                 if name.startswith(("repro_torch.launch",
                                     "repro_torch.lint"))
                 or name == "chip_smoke"]
        seen = set(reachable_closure(ctx, roots))
        tests_dir = ctx.root / "tests"
        test_imports: set[str] = set()
        if tests_dir.is_dir():
            for path in sorted(tests_dir.glob("test_torch_*.py")):
                try:
                    tree = ast.parse(path.read_text())
                except (OSError, SyntaxError):
                    continue
                fake = Module(name=f"tests.{path.stem}", path=path,
                              relpath=path.name, source="", lines=[],
                              tree=tree,
                              aliases=build_alias_map(tree, "tests"))
                test_imports |= all_imports(fake)
        seen |= set(reachable_closure(
            ctx, [m for m in test_imports if m in ctx.modules]))
        for name in sorted(ctx.modules):
            if not name.startswith("repro_torch") or name in seen:
                continue
            yield ctx.finding(
                self, ctx.modules[name], None,
                f"module `{name}` is unreachable from every entry point "
                f"(repro_torch.launch.*, repro_torch.lint, chip_smoke.py, "
                f"tests/test_torch_*.py): delete it or wire it to a real "
                f"consumer")

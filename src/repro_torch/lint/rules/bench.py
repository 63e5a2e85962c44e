"""REP701 — bench-schema: a module that writes a ``BENCH_*`` JSON
stamps a schema version.

A comparison across benchmark files only works if every writer stamps
``"schema_version": SCHEMA_VERSION`` into what it writes, a constant
rather than a number typed in place.  The port writes no ``BENCH_*``
file yet (its benchmarks will come with a ``BENCHMARK.json``), so the
rule runs clean on the tree; its fixtures show that it fires.

Scope: a module of the port that names a ``BENCH_`` artifact and
serializes JSON is a writer.  Findings: a writer with no
``"schema_version"`` key, and a ``"schema_version"`` given as a
literal instead of a ``SCHEMA_VERSION`` constant.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint import Context, Finding, Module, Rule
from repro_torch.lint.astutil import resolve_dotted


class BenchSchemaRule(Rule):
    id = "REP701"
    name = "bench-schema"
    severity = "error"
    description = ("modules that write BENCH_*.json must stamp "
                   "schema_version from a SCHEMA_VERSION constant")

    def applies(self, mod: Module, ctx: Context) -> bool:
        return mod.name.startswith("repro_torch") or mod.name == "chip_smoke"

    def check_module(self, mod: Module, ctx: Context) -> Iterator[Finding]:
        names_bench = any(
            isinstance(n, ast.Constant) and isinstance(n.value, str)
            and "BENCH_" in n.value for n in ast.walk(mod.tree))
        dumps = [n for n in ast.walk(mod.tree)
                 if isinstance(n, ast.Call)
                 and resolve_dotted(n.func, mod.aliases)
                 in ("json.dump", "json.dumps")]
        if not (names_bench and dumps):
            return
        stamped = False
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant)
                        and k.value == "schema_version"):
                    continue
                stamped = True
                if isinstance(v, ast.Constant):
                    yield ctx.finding(
                        self, mod, v,
                        f"schema_version is hardcoded to {v.value!r}: "
                        f"stamp a SCHEMA_VERSION constant so that readers "
                        f"can fence schema drift")
        if not stamped:
            yield ctx.finding(
                self, mod, dumps[0],
                "this module writes a BENCH_*.json but never stamps "
                "\"schema_version\": SCHEMA_VERSION into it")

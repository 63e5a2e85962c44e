"""reprolint for the port: static analysis of ``repro_torch``.

The port rests on a handful of contracts that reviews have checked by
hand: the CUDA entry point, the wrapper that packs its arrays, the
plain version and the round loop mirror one output contract
(``kernels/photon_step/spec.py``); every sum a result carries is an
integer (int64 fixed point, integer atomics), so it has the same bits
in any order; float64 appears only where the contract asks for it (the
replay's Jacobian, host-side analysis); a round reads the host once;
the kernel's static shared memory fits a Hopper block.  This package
turns them into rules, in two tiers:

* the AST tier (REP101-REP701, :mod:`repro_torch.lint.rules`) parses
  ``src/repro_torch/**`` and ``chip_smoke.py`` (and the kernels' ``.cu``
  and ``.cpp`` as text) and never imports the code under analysis;
* the traced tier (REP801-REP805, :mod:`repro_torch.lint.traced`)
  records the aten operations that real calls issue on the CPU.

Usage::

    PYTHONPATH=src python -m repro_torch.lint                # AST tier
    PYTHONPATH=src python -m repro_torch.lint --tier all     # both
    PYTHONPATH=src python -m repro_torch.lint --format json

Findings are suppressed by a same-line pragma ``# reprolint:
disable=REP301 - why`` (``// reprolint: ...`` in the ``.cu`` and the
``.cpp``), the
committed ``.reprolint-torch.json`` baseline (kept empty), or
``--rules`` selection; the traced tier by ``.tracelint-torch-allow.json``
entries, each with a ``why`` and a ``max``.

Adding a rule: subclass :class:`Rule` in a module under ``rules/``,
append it to ``rules.ALL_RULES`` and give it a fixture test that shows
it fires and one that shows it stays quiet (``tests/test_torch_lint.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.lint import astutil

__all__ = [
    "Finding", "Module", "Context", "Rule", "LintReport", "run_lint",
    "discover_modules", "traced_closure", "normalize_line", "pragma_rules",
    "TRACED_ENTRYPOINTS", "KERNEL_SOURCE", "HOST_KERNEL_SOURCE",
    "REGEN_KERNEL_SOURCE", "KERNEL_SOURCES",
]

# Modules whose import closure runs photons: everything reachable (by
# module-level imports) from the round loop, the kernel's wrapper, its
# plain version, the replay and the child process's entry.  The
# determinism and dtype rules police it.  Function-level lazy imports
# are not followed: that is how host-side schedulers stay outside.
TRACED_ENTRYPOINTS = (
    "repro_torch.core.simulator",
    "repro_torch.replay",
    "repro_torch.kernels.photon_step.ops",
    "repro_torch.kernels.photon_step.ref",
    "repro_torch.kernels.photon_step.photon_step",
    "repro_torch.core.procs",
)

# The CUDA source the mirror, determinism and shared-memory rules read
KERNEL_SOURCE = "src/repro_torch/kernels/photon_step/csrc/photon_step.cu"
# The host kernel's C++ source, which the mirror, determinism and dtype
# rules read as they read the CUDA source
HOST_KERNEL_SOURCE = ("src/repro_torch/kernels/photon_step/csrc/"
                      "photon_step_cpu.cpp")
# The regeneration kernel's CUDA source, which the determinism and dtype
# rules read as they read the others
REGEN_KERNEL_SOURCE = ("src/repro_torch/kernels/photon_step/csrc/"
                       "regenerate.cu")
KERNEL_SOURCES = (KERNEL_SOURCE, HOST_KERNEL_SOURCE, REGEN_KERNEL_SOURCE)

_PRAGMA_RE = re.compile(r"(?:#|//)\s*reprolint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # "REP201"
    name: str          # "determinism"
    severity: str      # "error" | "warning"
    path: str          # repo-relative posix path
    line: int          # 1-indexed
    col: int
    message: str
    fingerprint: str = ""  # stable id for the baseline (engine-filled)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}[{self.name}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Module:
    """A parsed source file."""

    name: str          # dotted module name ("repro_torch.core.photon")
    path: Path
    relpath: str       # repo-relative posix path
    source: str
    lines: list[str]
    tree: ast.Module
    aliases: dict[str, str]

    @property
    def package(self) -> str:
        if self.path.name == "__init__.py":
            return self.name
        return self.name.rpartition(".")[0]

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Context:
    """Everything a rule can see: the parsed tree, and any other file
    of the repo as text."""

    def __init__(self, root: Path, modules: dict[str, Module]):
        self.root = root
        self.modules = modules
        self.by_relpath = {m.relpath: m for m in modules.values()}
        self._traced: frozenset[str] | None = None
        self._texts: dict[str, list[str] | None] = {}

    def module(self, name: str) -> Module | None:
        return self.modules.get(name)

    def text_lines(self, relpath: str) -> list[str] | None:
        """A repo file's lines (a module's, or any text file's), or
        None when it does not exist."""
        if relpath in self.by_relpath:
            return self.by_relpath[relpath].lines
        if relpath not in self._texts:
            path = self.root / relpath
            self._texts[relpath] = (path.read_text().splitlines()
                                    if path.is_file() else None)
        return self._texts[relpath]

    def line_text(self, relpath: str, line: int) -> str:
        lines = self.text_lines(relpath) or []
        return lines[line - 1] if 1 <= line <= len(lines) else ""

    @property
    def traced_modules(self) -> frozenset[str]:
        if self._traced is None:
            self._traced = traced_closure(self)
        return self._traced

    def finding(self, rule: "Rule", mod: Module | None, node: ast.AST | None,
                message: str, path: str | None = None,
                line: int | None = None) -> Finding:
        if line is None:
            line = getattr(node, "lineno", 1) if node is not None else 1
        col = getattr(node, "col_offset", 0) if node is not None else 0
        return Finding(rule=rule.id, name=rule.name, severity=rule.severity,
                       path=path or (mod.relpath if mod else "<repo>"),
                       line=line, col=col, message=message)


class Rule:
    """Base class of the AST-tier rules.

    Subclasses set ``id``/``name``/``severity``/``description`` and
    override ``check_module`` (per-module rules; gate scope with
    ``applies``) or ``check`` (whole-repo rules).
    """

    id: str = "REP000"
    name: str = "base"
    severity: str = "error"
    description: str = ""

    def applies(self, mod: Module, ctx: Context) -> bool:
        return True

    def check_module(self, mod: Module, ctx: Context) -> Iterator[Finding]:
        return iter(())

    def check(self, ctx: Context) -> Iterator[Finding]:
        for mod in sorted(ctx.modules.values(), key=lambda m: m.relpath):
            if self.applies(mod, ctx):
                yield from self.check_module(mod, ctx)


def discover_modules(root: Path) -> dict[str, Module]:
    """Parse the linted file set: ``src/repro_torch/**`` and the root's
    ``chip_smoke.py`` (module ``chip_smoke``).  Tests are read only for
    their imports (the reachability rule's roots)."""
    root = Path(root)
    modules: dict[str, Module] = {}
    pkg = root / "src" / "repro_torch"
    specs = [(root / "src", sorted(pkg.rglob("*.py")) if pkg.is_dir()
              else []),
             (root, [root / "chip_smoke.py"]
              if (root / "chip_smoke.py").is_file() else [])]
    for base, paths in specs:
        for path in paths:
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(base)
            parts = list(rel.with_suffix("").parts)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            name = ".".join(parts)
            try:
                source = path.read_text()
                tree = ast.parse(source, filename=str(path))
            except (OSError, SyntaxError):
                continue  # unparseable files are the compiler's problem
            package = name if path.name == "__init__.py" else \
                name.rpartition(".")[0]
            modules[name] = Module(
                name=name, path=path,
                relpath=path.relative_to(root).as_posix(),
                source=source, lines=source.splitlines(), tree=tree,
                aliases=astutil.build_alias_map(tree, package))
    return modules


def module_level_imports(mod: Module) -> set[str]:
    """Absolute module names imported at a module's top level."""
    out: set[str] = set()
    for node in mod.tree.body:
        out |= _imports_of(node, mod.package)
    return out


def all_imports(mod: Module) -> set[str]:
    """Absolute module names imported anywhere (lazy imports included)."""
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        out |= _imports_of(node, mod.package)
    return out


def _imports_of(node: ast.AST, package: str) -> set[str]:
    out: set[str] = set()
    if isinstance(node, ast.Import):
        for a in node.names:
            out.add(a.name)
    elif isinstance(node, ast.ImportFrom):
        base = astutil.resolve_from_module(node, package)
        if base:
            out.add(base)
            for a in node.names:
                if a.name != "*":
                    out.add(f"{base}.{a.name}")
    return out


def _close_over(ctx: Context, roots: Iterable[str],
                imports_of) -> frozenset[str]:
    seen: set[str] = set()
    stack = [r for r in roots if r in ctx.modules]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        # importing a submodule imports its ancestor packages too
        parts = name.split(".")
        for i in range(1, len(parts)):
            anc = ".".join(parts[:i])
            if anc in ctx.modules and anc not in seen:
                stack.append(anc)
        mod = ctx.modules.get(name)
        if mod is None:
            continue
        for imp in imports_of(mod):
            if imp in ctx.modules and imp not in seen:
                stack.append(imp)
    return frozenset(seen)


def traced_closure(ctx: Context) -> frozenset[str]:
    """Modules reachable from the traced entry points by top-level
    imports (the determinism / dtype scope)."""
    return _close_over(ctx, TRACED_ENTRYPOINTS, module_level_imports)


def reachable_closure(ctx: Context, roots: Iterable[str]) -> frozenset[str]:
    """Modules reachable from ``roots`` by *any* import (lazy imports
    keep a module alive)."""
    return _close_over(ctx, roots, all_imports)


def pragma_rules(line_text: str) -> set[str] | None:
    """Rule ids disabled by a same-line pragma, or None."""
    m = _PRAGMA_RE.search(line_text)
    if not m:
        return None
    return {p.strip() for p in m.group(1).split(",") if p.strip()}


def normalize_line(text: str) -> str:
    """Canonical form of a source line for fingerprinting: any trailing
    comment stripped (quote-aware, so ``#`` inside a string survives)
    and all whitespace removed, so that whitespace- and comment-only
    edits never invalidate a baseline fingerprint."""
    out: list[str] = []
    quote: str | None = None
    for ch in text:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join("".join(out).split())


def fingerprint(rule: str, path: str, line_text: str) -> str:
    """A finding's stable id: rule, path and normalized line."""
    raw = f"{rule}:{path}:{normalize_line(line_text)}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]           # live (reported) findings
    suppressed_pragma: int
    suppressed_baseline: int
    n_modules: int
    rules_run: list[str]

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "version": 1,
            "clean": self.clean,
            "n_modules": self.n_modules,
            "rules": self.rules_run,
            "suppressed": {"pragma": self.suppressed_pragma,
                           "baseline": self.suppressed_baseline},
            "findings": [f.to_json() for f in self.findings],
        }


def apply_baseline(live: list[Finding],
                   baseline: dict[str, int] | None) -> tuple[list, int]:
    """The findings a fingerprint -> count baseline does not cover, and
    how many it covered."""
    if not baseline:
        return live, 0
    budget = dict(baseline)
    kept = []
    for f in live:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            kept.append(f)
    return kept, len(live) - len(kept)


def run_lint(root: Path | str, rules: Iterable[Rule] | None = None,
             baseline: dict[str, int] | None = None,
             rule_ids: Iterable[str] | None = None) -> LintReport:
    """Lint the tree at ``root`` and return the report.

    ``rule_ids`` selects some of the registered rules by id or name;
    ``baseline`` is the fingerprint -> count map of grandfathered
    findings.
    """
    from repro_torch.lint.rules import ALL_RULES

    root = Path(root)
    active = list(rules) if rules is not None else [r() for r in ALL_RULES]
    if rule_ids is not None:
        wanted = set(rule_ids)
        active = [r for r in active if r.id in wanted or r.name in wanted]
    ctx = Context(root, discover_modules(root))

    raw: list[Finding] = []
    for rule in active:
        raw.extend(rule.check(ctx))
    raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    live: list[Finding] = []
    n_pragma = 0
    for f in raw:
        text = ctx.line_text(f.path, f.line)
        disabled = pragma_rules(text)
        if disabled and (f.rule in disabled or "all" in disabled):
            n_pragma += 1
            continue
        live.append(dataclasses.replace(
            f, fingerprint=fingerprint(f.rule, f.path, text)))
    live, n_base = apply_baseline(live, baseline)
    return LintReport(findings=live, suppressed_pragma=n_pragma,
                      suppressed_baseline=n_base,
                      n_modules=len(ctx.modules),
                      rules_run=[r.id for r in active])

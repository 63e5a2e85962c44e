"""REP201 — determinism: no ambient nondeterminism, and only integer
sums.

The port's bits rest on two properties: every random number and every
control decision of a photon is a function of ``(seed, 64-bit photon
id)`` (the counter-based generators of ``repro_torch.core.rng``), and
every total a result carries is an integer sum (int64 fixed point),
which has the same bits in any order of its adds.  So:

* in the traced closure (modules reachable from the round loop, the
  kernel's wrapper, its plain version, the replay and the child
  process's entry by top-level imports): no host RNG
  (``numpy.random``, ``random``, ``secrets``, ``uuid``), no torch RNG
  (``torch.rand*``, ``torch.normal``, ``torch.bernoulli``,
  ``torch.multinomial``, ``torch.Generator``, ``torch.manual_seed``), no
  wall clocks, no iteration over a ``set``; and no ``index_add_``,
  ``scatter_add_``, ``scatter_reduce_`` or ``index_put_(...,
  accumulate=True)`` that adds anything but int64 fixed point (a value
  made by ``to_fixed`` or converted to ``torch.int64``);
* in the kernels' ``.cu`` and ``.cpp``: every ``atomicAdd`` (CUDA) and
  ``__atomic_fetch_add`` / ``__atomic_add_fetch`` (GCC's host atomics)
  adds an integer type (a float atomic add is order-dependent).

Host-side code in a traced module (a deadline, a wall time reported
beside a result) carries ``# reprolint: disable=REP201 - why``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.lint import KERNEL_SOURCES, Context, Finding, Module, Rule
from repro_torch.lint.astutil import matches_prefix, resolve_dotted

BANNED_PREFIXES = (
    "numpy.random",
    "random",
    "secrets",
    "uuid",
    "torch.rand",
    "torch.rand_like",
    "torch.randn",
    "torch.randn_like",
    "torch.randint",
    "torch.randint_like",
    "torch.randperm",
    "torch.normal",
    "torch.bernoulli",
    "torch.multinomial",
    "torch.poisson",
    "torch.Generator",
    "torch.manual_seed",
    "torch.seed",
    "torch.cuda.manual_seed",
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
    "datetime.datetime.now",
    "datetime.datetime.today",
    "datetime.datetime.utcnow",
    "datetime.date.today",
)

_WHY = {
    "uuid": "ambient ids break bit-identical replay",
    "time": "wall-clock values differ across runs and devices",
    "datetime": "wall-clock values differ across runs and devices",
}

# in-place accumulating tensor methods
_ACCUMULATES = ("index_add_", "scatter_add_", "scatter_reduce_",
                "index_put_")
# integer types an atomicAdd may add in the .cu
_INT_TYPES = {"u64", "int", "unsigned", "int32_t", "int64_t", "uint32_t",
              "uint64_t", "long", "unsigned long long", "long long"}


def _is_fixed_value(node: ast.AST, aliases: dict) -> bool:
    """An expression that is int64 fixed point by construction."""
    if isinstance(node, ast.Call):
        f = node.func
        name = (f.attr if isinstance(f, ast.Attribute)
                else getattr(f, "id", ""))
        if name == "to_fixed" or name == "long":
            return True
        if name == "to":
            args = list(node.args) + [k.value for k in node.keywords
                                      if k.arg == "dtype"]
            return any(resolve_dotted(a, aliases) == "torch.int64"
                       for a in args)
    return False


class DeterminismRule(Rule):
    id = "REP201"
    name = "determinism"
    severity = "error"
    description = ("forbid ambient RNG, wall clocks, set iteration and "
                   "float accumulation in the traced closure, and float "
                   "atomics in the kernel")

    def applies(self, mod: Module, ctx: Context) -> bool:
        return mod.name in ctx.traced_modules

    def check(self, ctx: Context) -> Iterator[Finding]:
        yield from super().check(ctx)
        yield from self._check_kernel(ctx)

    def check_module(self, mod: Module, ctx: Context) -> Iterator[Finding]:
        # ast.walk is breadth-first: flag the outermost match of an
        # attribute chain once and skip its own sub-expressions
        skip: set[int] = set()
        for node in ast.walk(mod.tree):
            if id(node) in skip:
                skip.update(id(c) for c in ast.iter_child_nodes(node))
                continue
            if isinstance(node, (ast.Attribute, ast.Name)):
                if isinstance(node, ast.Name) and node.id not in \
                        mod.aliases:
                    continue
                resolved = resolve_dotted(node, mod.aliases)
                hit = resolved and matches_prefix(resolved, BANNED_PREFIXES)
                if not hit:
                    continue
                skip.update(id(c) for c in ast.iter_child_nodes(node))
                why = _WHY.get(hit.split(".")[0],
                               "its values are not a function of (seed, "
                               "photon id)")
                yield ctx.finding(
                    self, mod, node,
                    f"use of `{resolved}` in traced module `{mod.name}`: "
                    f"{why}")
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("set", "frozenset")):
                    anchor = node if isinstance(node, ast.For) else it
                    yield ctx.finding(
                        self, mod, anchor,
                        f"iteration over a set in traced module "
                        f"`{mod.name}`: hash order leaks into the order "
                        f"of operations; iterate a sorted() or tuple view")
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr in _ACCUMULATES:
                yield from self._check_accumulate(node, mod, ctx)

    def _check_accumulate(self, call: ast.Call, mod: Module,
                          ctx: Context) -> Iterator[Finding]:
        method = call.func.attr
        if method == "index_put_" and not any(
                k.arg == "accumulate" and isinstance(k.value, ast.Constant)
                and k.value.value is True for k in call.keywords):
            return  # a plain write, not a sum
        args = list(call.args)
        value = args[-1] if args else next(
            (k.value for k in call.keywords
             if k.arg in ("source", "src", "values")), None)
        if value is not None and _is_fixed_value(value, mod.aliases):
            return
        yield ctx.finding(
            self, mod, call,
            f"`{method}` in traced module `{mod.name}` adds a value that "
            f"is not int64 fixed point (`to_fixed(...)` or "
            f"`.to(torch.int64)`): a float sum depends on the order of "
            f"its adds")

    def _check_kernel(self, ctx: Context) -> Iterator[Finding]:
        for source in KERNEL_SOURCES:
            lines = ctx.text_lines(source)
            if lines is None:
                continue
            text = "\n".join(_code(line) for line in lines)
            for m in _ATOMIC_ADD.finditer(text):
                line = text.count("\n", 0, m.start()) + 1
                # atomicAdd(p, v); __atomic_fetch_add(p, v, order)
                args = _arguments(text, m.end())
                value = args[-1] if m.group(1) == "atomicAdd" else (
                    args[1] if len(args) > 1 else "")
                kind = _declared_type(text[:m.start()], value)
                if kind is None or kind not in _INT_TYPES:
                    kind = kind or "type not found"
                    yield Finding(
                        rule=self.id, name=self.name,
                        severity=self.severity, path=source, line=line,
                        col=0,
                        message=f"{m.group(1)} of `{value}` ({kind}): only "
                                f"integer atomics keep a sum independent "
                                f"of the order of its adds")


def _code(line: str) -> str:
    """A line of C++ without its ``//`` comment."""
    return line.split("//", 1)[0]


_ATOMIC_ADD = re.compile(
    r"\b(atomicAdd|__atomic_fetch_add|__atomic_add_fetch)\s*\(")


def _arguments(text: str, start: int) -> list[str]:
    """The arguments of the call whose ``(`` ends at ``start``."""
    depth, arg_start, args = 0, start, []
    for i in range(start, len(text)):
        ch = text[i]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            if depth == 0:
                return args + [text[arg_start:i].strip()]
            depth -= 1
        elif ch == "," and depth == 0:
            args.append(text[arg_start:i].strip())
            arg_start = i + 1
    return args + [text[arg_start:].strip()]


def _declared_type(before: str, value: str) -> str | None:
    """The type of the nearest declaration of the name ``value`` in the
    text before its use (``const u64 u = ...``, ``u64 u,``), of a cast
    ``(float)x``, or ``int`` for an integer literal (``1``, ``1LL``)."""
    cast = re.match(r"\(\s*([A-Za-z_][\w ]*?)\s*\)", value)
    if cast:
        return cast.group(1)
    if re.fullmatch(r"\d+[uUlL]*", value):
        return "int"
    if not re.fullmatch(r"[A-Za-z_]\w*", value):
        return None
    decls = [m.group(1) for m in re.finditer(
        r"\b((?:unsigned\s+)?(?:long\s+long|[A-Za-z_]\w*))\s+" +
        re.escape(value) + r"\s*[=,;)]", before)
        if m.group(1) not in _KEYWORDS]
    return decls[-1] if decls else None


_KEYWORDS = {"return", "case", "else", "sizeof", "const", "volatile"}

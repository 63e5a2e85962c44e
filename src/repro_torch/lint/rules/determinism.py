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
* in the kernel's ``.cu``: every ``atomicAdd`` adds an integer type
  (a float atomic add is order-dependent).

Host-side code in a traced module (a deadline, a wall time reported
beside a result) carries ``# reprolint: disable=REP201 - why``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.lint import KERNEL_SOURCE, Context, Finding, Module, Rule
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
        lines = ctx.text_lines(KERNEL_SOURCE)
        if lines is None:
            return
        text = "\n".join(_code(line) for line in lines)
        for m in re.finditer(r"\batomicAdd\s*\(", text):
            line = text.count("\n", 0, m.start()) + 1
            value = _last_argument(text, m.end())
            kind = _declared_type(text[:m.start()], value)
            if kind is None or kind not in _INT_TYPES:
                yield Finding(
                    rule=self.id, name=self.name, severity=self.severity,
                    path=KERNEL_SOURCE, line=line, col=0,
                    message=f"atomicAdd of `{value}` ({kind or 'type not '
                            f'found'}): only integer atomics keep a sum "
                            f"independent of the order of its adds")


def _code(line: str) -> str:
    """A line of C++ without its ``//`` comment."""
    return line.split("//", 1)[0]


def _last_argument(text: str, start: int) -> str:
    """The last argument of the call whose ``(`` ends at ``start``."""
    depth, arg_start = 0, start
    for i in range(start, len(text)):
        ch = text[i]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            if depth == 0:
                return text[arg_start:i].strip()
            depth -= 1
        elif ch == "," and depth == 0:
            arg_start = i + 1
    return text[arg_start:].strip()


def _declared_type(before: str, value: str) -> str | None:
    """The type of the nearest declaration of the name ``value`` in the
    text before its use (``const u64 u = ...``, ``u64 u,``), or of a
    cast ``(float)x``."""
    cast = re.match(r"\(\s*([A-Za-z_][\w ]*?)\s*\)", value)
    if cast:
        return cast.group(1)
    if not re.fullmatch(r"[A-Za-z_]\w*", value):
        return None
    decls = [m.group(1) for m in re.finditer(
        r"\b((?:unsigned\s+)?(?:long\s+long|[A-Za-z_]\w*))\s+" +
        re.escape(value) + r"\s*[=,;)]", before)
        if m.group(1) not in _KEYWORDS]
    return decls[-1] if decls else None


_KEYWORDS = {"return", "case", "else", "sizeof", "const", "volatile"}

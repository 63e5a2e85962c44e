"""REP501 — vmem-budget: the kernel's static shared memory fits a block.

The reference's rule holds the Pallas kernel's blocks to the TPU core's
VMEM; the port's kernel keeps its deposit cache, lane order and warp
counts in shared memory, and a block may ask for at most 48 KiB of it
statically.  A cache grown past that fails in ``nvcc`` or at launch,
on the card only.  As the reference's rule and ``spec.check_vmem``
share one formula, this rule and the wrapper share
``spec.shared_bytes`` / ``spec.check_shared`` (the wrapper applies it
when it loads a library, to ``photon_step_threads()`` and
``photon_step_cache_slots()``).

The rule reads the ``.cu`` as text: the ``constexpr int`` launch
constants (``kThreads``, ``kCacheLog2``, ``kCacheSlots``, ``kWarps``)
and every ``__shared__`` array of the kernel, whose bytes it adds up.
Findings: the bytes past ``spec.SHARED_LIMIT``; ``spec.shared_bytes``
disagreeing with the declarations (the formula no longer mirrors the
kernel); and the wrapper's ``THREADS`` / ``CACHE_SLOTS`` literals
disagreeing with the kernel's constants.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.lint import KERNEL_SOURCE, Context, Finding, Rule
from repro_torch.lint.astutil import load_literal_constants

_SIZEOF = {"int": 4, "unsigned": 4, "float": 4, "int32_t": 4,
           "uint32_t": 4, "u64": 8, "int64_t": 8, "uint64_t": 8,
           "double": 8, "long long": 8, "unsigned long long": 8,
           "uint8_t": 1, "char": 1, "bool": 1}
_WRAPPER = "repro_torch.kernels.photon_step.photon_step"


def _eval(expr: str, env: dict[str, int]) -> int | None:
    """An integer C expression of literals and known constants."""
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None
    ok = (ast.Expression, ast.BinOp, ast.Constant, ast.Name, ast.Load,
          ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.LShift, ast.RShift)
    if not all(isinstance(n, ok) for n in ast.walk(tree)):
        return None
    if any(isinstance(n, ast.Name) and n.id not in env
           for n in ast.walk(tree)):
        return None
    return int(eval(compile(tree, "<expr>", "eval"), {}, dict(env)))


def kernel_constants(text: str) -> dict[str, int]:
    """The ``constexpr int NAME = expr;`` constants of a ``.cu`` text."""
    env: dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", text):
        value = _eval(m.group(2), env)
        if value is not None:
            env[m.group(1)] = value
    return env


def shared_arrays(text: str, env: dict[str, int]):
    """``(name, bytes or None, line)`` of each ``__shared__`` array."""
    for m in re.finditer(r"__shared__\s+([A-Za-z_][\w ]*?)\s+(\w+)\s*"
                         r"\[([^\]]+)\]\s*;", text):
        n = _eval(m.group(3), env)
        size = _SIZEOF.get(m.group(1).strip())
        yield (m.group(2), None if n is None or size is None else n * size,
               text.count("\n", 0, m.start()) + 1)


class SharedMemoryRule(Rule):
    id = "REP501"
    name = "vmem-budget"
    severity = "error"
    description = ("the kernel's static shared memory a block fits the "
                   "limit spec.check_shared enforces when a library loads")

    def check(self, ctx: Context) -> Iterator[Finding]:
        from repro_torch.kernels.photon_step import spec

        lines = ctx.text_lines(KERNEL_SOURCE)
        if lines is None:
            return
        text = "\n".join(line.split("//", 1)[0] for line in lines)
        env = kernel_constants(text)

        def finding(line, message):
            return Finding(rule=self.id, name=self.name,
                           severity=self.severity, path=KERNEL_SOURCE,
                           line=line, col=0, message=message)

        arrays = list(shared_arrays(text, env))
        for name, nbytes, line in arrays:
            if nbytes is None:
                yield finding(line, f"the size of __shared__ `{name}` is "
                              f"not a constant this rule can evaluate")
        if not arrays or any(b is None for _, b, _ in arrays):
            return
        total = sum(b for _, b, _ in arrays)
        first = arrays[0][2]
        if total > spec.SHARED_LIMIT:
            yield finding(first, f"the kernel's blocks ask for {total} bytes "
                          f"of static shared memory, over the "
                          f"{spec.SHARED_LIMIT}-byte limit")
        threads, slots = env.get("kThreads"), env.get("kCacheSlots")
        if threads is None or slots is None:
            yield finding(first, "kThreads or kCacheSlots not found as a "
                          "constexpr int of the kernel")
            return
        formula = spec.shared_bytes(threads, slots)
        if formula != total:
            yield finding(first, f"spec.shared_bytes({threads}, {slots}) = "
                          f"{formula} bytes, but the kernel's __shared__ "
                          f"arrays take {total}: the formula no longer "
                          f"mirrors the kernel")
        wrapper = ctx.module(_WRAPPER)
        if wrapper is not None:
            consts = load_literal_constants(wrapper.tree)
            got = (consts.get("THREADS"), consts.get("CACHE_SLOTS"))
            if got != (threads, slots):
                yield ctx.finding(
                    self, wrapper, None,
                    f"the wrapper's (THREADS, CACHE_SLOTS) = {got}, the "
                    f"kernel's (kThreads, kCacheSlots) = "
                    f"{(threads, slots)}")

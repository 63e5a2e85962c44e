"""REP301 — dtype: float64 only where the contract asks for it.

The kernel and its plain version run in float32 (an H100's float64
rate is a fraction of its float32 rate, and the plain version must
give the kernel's bits); sums are int64 fixed point.  float64 belongs
in two places: the replay's Jacobian as it is handed to the caller, and
host-side analysis (energy balance, fits, derivations of a source's
static parameters, rounded once to float32).  Every float64 site of the
port therefore carries ``# reprolint: disable=REP301 - why``, so that a
reviewer can tell a deliberate one from a leak.

Flagged forms, in ``repro_torch`` modules:

* ``torch.float64`` / ``torch.double`` / ``numpy.float64`` /
  ``numpy.double`` / ``numpy.longdouble`` anywhere, and ``.double()``;
* ``dtype=float`` (the builtin ``float`` is float64 as a dtype) and
  ``dtype="float64"``;
* a bare ``float`` passed to an array constructor or ``.astype``;

and, in the kernels' ``.cu`` and ``.cpp`` (comments aside), the type
``double``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.lint import KERNEL_SOURCES, Context, Finding, Module, Rule
from repro_torch.lint.astutil import resolve_dotted

F64_NAMES = ("numpy.float64", "numpy.double", "numpy.longdouble",
             "torch.float64", "torch.double")

# constructors whose bare `float` positional argument means float64
_DTYPE_POS_CALLS = {"asarray", "array", "zeros", "ones", "full", "empty",
                    "astype", "arange", "asanyarray"}
_DTYPE_STRINGS = ("float64", "f8", "d", "double")
_WHY = ("float64 only where the contract asks (the replay's Jacobian, "
        "host-side analysis), each with a `# reprolint: disable=REP301 - "
        "why` pragma")


class DtypeRule(Rule):
    id = "REP301"
    name = "dtype"
    severity = "error"
    description = ("flag float64 dtypes and promotions; the kernel path is "
                   "float32 and int64 fixed point, deliberate float64 "
                   "needs a pragma")

    def applies(self, mod: Module, ctx: Context) -> bool:
        return mod.name.startswith("repro_torch")

    def check(self, ctx: Context) -> Iterator[Finding]:
        yield from super().check(ctx)
        for source in KERNEL_SOURCES:
            for i, line in enumerate(ctx.text_lines(source) or (), 1):
                if re.search(r"\bdouble\b", line.split("//", 1)[0]):
                    yield Finding(rule=self.id, name=self.name,
                                  severity=self.severity, path=source,
                                  line=i, col=0,
                                  message=f"`double` in the kernel: {_WHY}")

    def check_module(self, mod: Module, ctx: Context) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                resolved = resolve_dotted(node, mod.aliases)
                if resolved in F64_NAMES:
                    yield ctx.finding(self, mod, node,
                                      f"`{resolved}` in `{mod.name}`: {_WHY}")
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if isinstance(v, ast.Name) and v.id == "float":
                    yield ctx.finding(self, mod, v,
                                      f"`dtype=float` is float64: {_WHY}")
                elif isinstance(v, ast.Constant) and v.value in \
                        _DTYPE_STRINGS:
                    yield ctx.finding(
                        self, mod, v, f"`dtype={v.value!r}` is float64: "
                        f"{_WHY}")
            elif isinstance(node, ast.Call):
                f = node.func
                fname = (f.attr if isinstance(f, ast.Attribute)
                         else getattr(f, "id", None))
                if fname == "double" and isinstance(f, ast.Attribute) \
                        and not node.args:
                    yield ctx.finding(self, mod, node,
                                      f"`.double()` in `{mod.name}`: {_WHY}")
                elif fname in _DTYPE_POS_CALLS:
                    for arg in node.args:
                        if isinstance(arg, ast.Name) and arg.id == "float":
                            yield ctx.finding(
                                self, mod, arg,
                                f"bare `float` dtype in `{fname}(...)` is "
                                f"float64: {_WHY}")

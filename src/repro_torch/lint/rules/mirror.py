"""REP101 — mirror-drift: every mirror of the kernel's contract matches
``spec.py``.

The photon-step contract (``kernels/photon_step/spec.py``: the output
groups ``OUTPUT_GROUPS`` after the state and ``BASE_OUTPUTS``, the
entry points' ``CORE_PARAMS`` and ``EXT_PARAMS``) is written out by
hand in five places, which this rule reads without importing them:

* the CUDA entry point ``photon_step_launch`` (the ``.cu``, as text)
  and the host entry point ``photon_step_cpu_launch`` (the ``.cpp``):
  the first optional ``in`` / ``out`` slots (``i_in``, ``i_out``) and,
  under each group flag (``kDet``, ``kRecord``, ``kJac``, ``kStats``:
  ``PS_GROUPS`` bits in the ``.cu``, launch flags in the ``.cpp``), the
  slots it reads, in order;
* the wrapper's packing (``photon_step.prepare``): the base and guarded
  ``outs += [...]`` appends and the guarded ``ins += [...]`` inputs;
* the plain version (``ref.photon_steps_ref``): the base ``out`` tuple
  and its guarded ``out = out + (...)`` appends;
* the round loop's unpack (``simulator.build_round_loop``): the base
  ``outs[:k]`` and the guarded ``cur += k`` steps (a group it does not
  read may be absent, but order and arity must match; ``collect`` is
  the loop's name for ``stats``);
* the signatures of ``ops.photon_steps``, ``photon_step_cuda``,
  ``photon_step_host``, ``prepare`` and ``photon_steps_ref``:
  ``CORE_PARAMS`` first, then ``EXT_PARAMS`` in order.

Silent when the tree has no ``spec.py`` (fixture trees of other rules);
a mirror that is missing or cannot be read is itself a finding.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.lint import (HOST_KERNEL_SOURCE, KERNEL_SOURCE, Context,
                              Finding, Module, Rule)
from repro_torch.lint.astutil import (find_function, is_subsequence,
                                      load_literal_constants, param_names,
                                      test_flag_names)

_PKG = "repro_torch.kernels.photon_step"
SPEC = f"{_PKG}.spec"
# (module, function) of each mirror
SIGNATURES = ((f"{_PKG}.ops", "photon_steps"),
              (f"{_PKG}.photon_step", "photon_step_cuda"),
              (f"{_PKG}.photon_step_cpu", "photon_step_host"),
              (f"{_PKG}.photon_step", "prepare"),
              (f"{_PKG}.ref", "photon_steps_ref"))
# the kernels' group flags and the spec flag each stands for
CU_FLAGS = {"kDet": "n_det", "kRecord": "record", "kJac": "jac_cols",
            "kStats": "stats"}
# each kernel source and its C entry point
ENTRY_POINTS = ((KERNEL_SOURCE, "photon_step_launch"),
                (HOST_KERNEL_SOURCE, "photon_step_cpu_launch"))


class _Contract:
    """What ``spec.py`` says, as literals."""

    def __init__(self, consts: dict):
        self.state = tuple(consts["STATE_FIELDS"])
        self.base = tuple(consts["BASE_OUTPUTS"])
        self.groups = [(tuple(names), tuple(members))
                       for names, members in consts["OUTPUT_GROUPS"]]
        self.core = tuple(consts["CORE_PARAMS"])
        self.ext = tuple(consts["EXT_PARAMS"])
        flags = {n for names, _ in self.groups for n in names}
        # the optional tensor inputs, in order
        self.ext_tensors = tuple(p for p in self.ext if p not in flags)

    def group_of(self, flags: set[str]) -> int | None:
        for i, (names, _) in enumerate(self.groups):
            if flags & set(names):
                return i
        return None

    def expected(self) -> list[tuple[int, int]]:
        return [(i, len(m)) for i, (_, m) in enumerate(self.groups)]

    def show(self, seq) -> str:
        return "[" + ", ".join(f"{self.groups[i][0][0]}:{k}"
                               for i, k in seq) + "]"


def _guarded(fn: ast.AST, contract: _Contract, match) -> list:
    """``(group, value)`` of each statement ``match`` accepts under an
    ``if`` on a group's flag, in source order."""
    out = []

    def visit(stmts, group):
        for st in stmts:
            if isinstance(st, ast.If):
                g = contract.group_of(test_flag_names(st.test))
                visit(st.body, g if g is not None else group)
                visit(st.orelse, group)
                continue
            if group is not None:
                v = match(st)
                if v is not None:
                    out.append((group, v))
            for field in ("body", "orelse", "finalbody"):
                visit(getattr(st, field, []) or [], group)

    visit(fn.body, None)
    return out


def _list_append(target: str):
    def match(st):
        if isinstance(st, ast.AugAssign) and isinstance(st.op, ast.Add) \
                and isinstance(st.target, ast.Name) \
                and st.target.id == target and isinstance(st.value, ast.List):
            return st.value.elts
        return None
    return match


def _tuple_append(target: str):
    def match(st):
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and st.targets[0].id == target \
                and isinstance(st.value, ast.BinOp) \
                and isinstance(st.value.op, ast.Add) \
                and isinstance(st.value.left, ast.Name) \
                and st.value.left.id == target \
                and isinstance(st.value.right, ast.Tuple):
            return st.value.right.elts
        return None
    return match


def _cursor_step(target: str):
    def match(st):
        if isinstance(st, ast.AugAssign) and isinstance(st.op, ast.Add) \
                and isinstance(st.target, ast.Name) \
                and st.target.id == target \
                and isinstance(st.value, ast.Constant):
            return st.value.value
        return None
    return match


class MirrorRule(Rule):
    id = "REP101"
    name = "mirror-drift"
    severity = "error"
    description = ("the CUDA and host entry points, the wrapper's packing, "
                   "the plain version, the round loop's unpack and the "
                   "entry points' signatures must match "
                   "kernels/photon_step/spec.py")

    def check(self, ctx: Context) -> Iterator[Finding]:
        spec_mod = ctx.module(SPEC)
        if spec_mod is None:
            return
        try:
            contract = _Contract(load_literal_constants(spec_mod.tree))
        except (KeyError, TypeError, ValueError) as e:
            yield ctx.finding(self, spec_mod, None,
                              f"spec.py's contract constants cannot be "
                              f"read as literals: {e!r}")
            return
        yield from self._signatures(ctx, contract)
        yield from self._ref(ctx, contract)
        yield from self._wrapper(ctx, contract)
        yield from self._round_loop(ctx, contract)
        for source, entry in ENTRY_POINTS:
            yield from self._kernel(ctx, contract, source, entry)

    def _function(self, ctx, module: str, name: str):
        mod = ctx.module(module)
        fn = find_function(mod.tree, name) if mod is not None else None
        return mod, fn

    def _missing(self, ctx, mod, module, name) -> Finding:
        return ctx.finding(self, mod, None,
                           f"mirror `{module}.{name}` not found",
                           path=None if mod else f"<{module}>")

    def _signatures(self, ctx, c: _Contract) -> Iterator[Finding]:
        for module, name in SIGNATURES:
            mod, fn = self._function(ctx, module, name)
            if fn is None:
                yield self._missing(ctx, mod, module, name)
                continue
            params = param_names(fn)
            if tuple(params[:len(c.core)]) != c.core:
                yield ctx.finding(
                    self, mod, fn,
                    f"`{name}` starts with {params[:len(c.core)]}, not "
                    f"spec.CORE_PARAMS {list(c.core)}")
            elif not is_subsequence(c.ext, params[len(c.core):]):
                yield ctx.finding(
                    self, mod, fn,
                    f"`{name}` lacks spec.EXT_PARAMS {list(c.ext)} in "
                    f"order after its core parameters (has "
                    f"{params[len(c.core):]})")

    def _compare(self, ctx, mod, node, what, got, c, subsequence=False):
        want = c.expected()
        ok = (all(g in want for g in got)
              and [g for g in want if g in got] == got) if subsequence \
            else got == want
        if not ok:
            return ctx.finding(
                self, mod, node,
                f"{what}: groups {c.show(got)}, spec.OUTPUT_GROUPS "
                f"{c.show(want)}")
        return None

    def _ref(self, ctx, c: _Contract) -> Iterator[Finding]:
        module, name = f"{_PKG}.ref", "photon_steps_ref"
        mod, fn = self._function(ctx, module, name)
        if fn is None:
            return  # the signature check reported it
        base = [st for st in ast.walk(fn) if isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and st.targets[0].id == "out"
                and isinstance(st.value, ast.Tuple)]
        if not base or len(base[0].value.elts) != 1 + len(c.base):
            yield ctx.finding(
                self, mod, base[0] if base else fn,
                f"`{name}`'s base `out` tuple must hold the state and "
                f"spec.BASE_OUTPUTS ({1 + len(c.base)} values)")
        got = [(g, len(v)) for g, v in _guarded(fn, c, _tuple_append("out"))]
        bad = self._compare(ctx, mod, fn, f"`{name}` appends", got, c)
        if bad:
            yield bad

    def _wrapper(self, ctx, c: _Contract) -> Iterator[Finding]:
        module, name = f"{_PKG}.photon_step", "prepare"
        mod, fn = self._function(ctx, module, name)
        if fn is None:
            return
        outs = _list_append("outs")
        base = [st for st in fn.body if outs(st) is not None]
        if not base or len(outs(base[0])) != len(c.base):
            yield ctx.finding(
                self, mod, base[0] if base else fn,
                f"`{name}`'s first `outs += [...]` must be "
                f"spec.BASE_OUTPUTS ({len(c.base)} outputs)")
        got = [(g, len(v)) for g, v in _guarded(fn, c, outs)]
        bad = self._compare(ctx, mod, fn, f"`{name}`'s output slots", got, c)
        if bad:
            yield bad
        ins = [getattr(e, "id", "?") for _, v in
               _guarded(fn, c, _list_append("ins")) for e in v]
        if tuple(ins) != c.ext_tensors:
            yield ctx.finding(
                self, mod, fn,
                f"`{name}`'s optional input slots {ins}, spec.EXT_PARAMS' "
                f"tensors {list(c.ext_tensors)}")

    def _round_loop(self, ctx, c: _Contract) -> Iterator[Finding]:
        module, name = "repro_torch.core.simulator", "build_round_loop"
        mod, fn = self._function(ctx, module, name)
        if fn is None:
            if mod is not None:
                yield self._missing(ctx, mod, module, name)
            return
        base = [n for n in ast.walk(fn) if isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name) and n.value.id == "outs"
                and isinstance(n.slice, ast.Slice) and n.slice.lower is None
                and isinstance(n.slice.upper, ast.Constant)]
        if not base or base[0].slice.upper.value != 1 + len(c.base):
            yield ctx.finding(
                self, mod, base[0] if base else fn,
                f"`{name}` must unpack `outs[:{1 + len(c.base)}]`: the "
                f"state and spec.BASE_OUTPUTS")
        got = _guarded(fn, c, _cursor_step("cur"))
        bad = self._compare(ctx, mod, fn, f"`{name}`'s unpack", got, c,
                            subsequence=True)
        if bad:
            yield bad

    def _kernel(self, ctx, c: _Contract, source: str,
                entry: str) -> Iterator[Finding]:
        lines = ctx.text_lines(source)
        if lines is None:
            return
        text = "\n".join(line.split("//", 1)[0] for line in lines)

        def finding(pos, message):
            return Finding(rule=self.id, name=self.name,
                           severity=self.severity, path=source,
                           line=text.count("\n", 0, pos) + 1, col=0,
                           message=message)

        m = re.search(r"\bint\s+" + entry + r"\s*\(", text)
        if m is None:
            yield finding(0, f"entry point `{entry}` not found")
            return
        body = text[m.start():]
        cursors = re.search(r"int\s+i_in\s*=\s*(\d+)\s*,\s*i_out\s*=\s*(\d+)",
                            body)
        n_in = 2 + len(c.state) + 1    # labels, media, the state, errors
        n_out = len(c.state) + len(c.base)
        if cursors is None or (int(cursors.group(1)),
                               int(cursors.group(2))) != (n_in, n_out):
            yield finding(m.start(), f"{entry}'s optional slots "
                          f"must start at in[{n_in}] and out[{n_out}] (the "
                          f"state and spec.BASE_OUTPUTS)")
            return
        # each `if (kX)` block or statement: the slots it assigns
        outs, ins = [], []
        for blk in re.finditer(r"if\s*\(\s*(k[A-Z]\w*)\s*\)\s*"
                               r"(\{[^{}]*\}|[^;]*;)",
                               body[cursors.end():]):
            flag = CU_FLAGS.get(blk.group(1))
            if flag is None:
                continue
            g = c.group_of({flag})
            for slot, side in re.findall(
                    r"\w+\.(\w+)\s*=\s*\([^)]*\)\s*(in|out)\[i_(?:in|out)"
                    r"\+\+\]", blk.group(2)):
                name = re.sub(r"_(in|out)$", "", slot)
                (outs if side == "out" else ins).append((g, name))
        want_out = [(i, name) for i, (_, members) in enumerate(c.groups)
                    for name in members]
        if outs != want_out:
            yield finding(m.start(), f"{entry}'s optional out "
                          f"slots {[n for _, n in outs]}, "
                          f"spec.OUTPUT_GROUPS "
                          f"{[n for _, n in want_out]}")
        if tuple(n for _, n in ins) != c.ext_tensors:
            yield finding(m.start(), f"{entry}'s optional in "
                          f"slots {[n for _, n in ins]}, spec.EXT_PARAMS' "
                          f"tensors {list(c.ext_tensors)}")

"""SASS instruction counts of the photon-step kernel, by source region.

    python -m repro_torch.kernels.photon_step.sass [--groups 0]

Needs the CUDA toolkit (``cuobjdump``, ``nvdisasm``) and a library built
with ``-lineinfo``, which ``photon_step.NVCC_FLAGS`` carries: line tables
only, the code is the same.  Every instruction of each kernel
instantiation is attributed to the line of ``csrc/photon_step.cu`` it
came from, and the lines to the region that the last ``// --- NAME``
marker above them opens; code inlined from a helper above the first
marker counts in its caller's region.  Instructions that only run in
rare cases are counted apart as ``cold``: the fall-through of a branch
whose body calls a subroutine (the slow paths of IEEE division and
square root) or holds a loop through local memory (the range reduction
of a large sine argument).

``issue_ms`` turns the counts into the least time the SMs need to issue
them, at one warp instruction a clock on each of the 4 schedulers of
each SM.  The parsing needs no card and is tested on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "photon_step.cu"

# H100 SXM: 132 SMs, 4 warp schedulers each issuing one instruction a
# clock, 1.98 GHz boost clock.
WARP_ISSUE_PER_S = 4 * 132 * 1.98e9

_FUNC = re.compile(r"^\.text\.(\S+):\s*$")
_LINE = re.compile(r'//## File "([^"]*)", line (\d+)'
                   r'(?: inlined at "([^"]*)", line (\d+))?')
_INSTR = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^(\.L_x_\d+):")
_BRANCH = re.compile(r"^@!?U?P\w+\s+BRA\s+`\((\.L_x_\d+)\)")
_JUMP = re.compile(r"^BRA\s+`\((\.L_x_\d+)\)")
_LOCAL = re.compile(r"\b(STL|LDL)\b")
_MARKER = re.compile(r"^\s*// --- ([A-Za-z][\w-]*)")


def regions(source: str) -> list[tuple[int, str]]:
    """``(first_line, name)`` of each ``// --- NAME`` marker, in order."""
    return [(i, m.group(1)) for i, line in enumerate(source.splitlines(), 1)
            if (m := _MARKER.match(line))]


def region_of(line: int, marks: list[tuple[int, str]]) -> str:
    name = "(before)"
    for first, mark in marks:
        if first > line:
            break
        name = mark
    return name


def parse(disasm: str, source_name: str) -> dict[str, list]:
    """Per kernel (mangled name): a list of ``(lines, text)``, one entry
    an instruction, with ``lines`` the lines of ``source_name`` it came
    from, innermost first (nvdisasm ``-gi`` prints an inlined
    instruction's call sites outward), and ``text`` the instruction, or
    ``(None, label)`` for a label."""
    out: dict[str, list] = {}
    body = None
    lines: tuple[int, ...] = ()
    pending: list[int] = []
    for raw in disasm.splitlines():
        m = _FUNC.match(raw.strip())
        if m:
            body = out.setdefault(m.group(1), [])
            lines, pending = (), []
            continue
        if body is None:
            continue
        m = _LINE.search(raw)
        if m:
            file, num, outer_file, outer_num = m.groups()
            if file.endswith(source_name):
                pending.append(int(num))
            if outer_file and outer_file.endswith(source_name):
                pending.append(int(outer_num))
            continue
        m = _LABEL.match(raw.strip())
        if m:
            body.append((None, m.group(1)))
            continue
        m = _INSTR.match(raw)
        if m:
            if pending:
                lines, pending = tuple(dict.fromkeys(pending)), []
            body.append((lines, m.group(1)))
    return out


def region_of_chain(lines, marks) -> str:
    """The region of the innermost call site that lies in a marked
    region (helpers defined above the first marker take their caller's
    region)."""
    for line in lines:
        name = region_of(line, marks)
        if name != "(before)":
            return name
    return "(before)"


def cold_mask(body: list, longest: int = 100) -> list[bool]:
    """True for each entry on a rare path: the instructions between a
    forward conditional branch and its label, at most ``longest`` of
    them, when they call a subroutine or hold a loop through local
    memory, and no shorter such span lies inside them.  (A loop without
    local memory, such as the compare-and-swap retry of a float atomic
    in shared memory, is on the hot path.)"""
    labels = {text: i for i, (ln, text) in enumerate(body) if ln is None}

    def local_loop(j: int, text: str) -> bool:
        b = _BRANCH.match(text) or _JUMP.match(text)
        start = labels.get(b.group(1), j) if b else j
        return start < j and any(
            body[k][0] is not None and _LOCAL.search(body[k][1])
            for k in range(start, j))

    spans = []
    for i, (ln, text) in enumerate(body):
        m = _BRANCH.match(text) if ln is not None else None
        if not m or not i < labels.get(m.group(1), -1) <= i + longest + 1:
            continue
        lo, hi = i + 1, labels[m.group(1)]
        if any(body[j][0] is not None and (body[j][1].startswith("CALL")
                                           or local_loop(j, body[j][1]))
               for j in range(lo, hi)):
            spans.append((lo, hi))
    cold = [False] * len(body)
    for lo, hi in spans:
        if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in spans):
            for j in range(lo, hi):
                cold[j] = True
    return cold


def count(disasm: str, source: str, source_name: str) -> dict:
    """``{kernel: {region: {"hot": n, "cold": n}}}`` from nvdisasm output
    with line information and the source it was built from.  Code after
    the kernel's last ``EXIT`` (its subroutines) is cold."""
    marks = regions(source)
    out = {}
    for name, body in parse(disasm, source_name).items():
        cold = cold_mask(body)
        exits = [i for i, (ln, t) in enumerate(body)
                 if ln is not None and t.split()[-1] == "EXIT"
                 and not t.startswith("@")]
        end = exits[-1] if exits else len(body) - 1
        tally = collections.defaultdict(lambda: {"hot": 0, "cold": 0})
        for i, (ln, text) in enumerate(body):
            if ln is None or text.startswith("NOP"):
                continue
            kind = "cold" if cold[i] or i > end else "hot"
            tally[region_of_chain(ln, marks)][kind] += 1
        out[name] = dict(tally)
    return out


def template_flags(mangled: str) -> tuple[bool, ...]:
    """The bool template arguments of a mangled kernel name, in order."""
    m = re.search(r"photon_step_kernelI((?:Lb[01]E)+)E", mangled)
    return tuple(f == "1" for f in re.findall(r"Lb([01])E", m.group(1))) \
        if m else ()


def issue_ms(counts: dict, warp_execs: dict) -> float:
    """Least time to issue ``counts[region]["hot"]`` instructions
    ``warp_execs[region]`` times each, summed over regions."""
    instr = sum(counts.get(r, {}).get("hot", 0) * n
                for r, n in warp_execs.items())
    return instr / WARP_ISSUE_PER_S * 1e3


def disassemble(library: pathlib.Path) -> str:
    """nvdisasm of every cubin in a built library, with line info."""
    tools = pathlib.Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    cuobjdump = tools.parent / "cuobjdump"
    nvdisasm = tools.parent / "nvdisasm"
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(cuobjdump), "-xelf", "all", str(library)],
                       cwd=tmp, check=True, capture_output=True)
        texts = [subprocess.run([str(nvdisasm), "-g", "-gi", "-c", str(c)],
                                check=True, capture_output=True,
                                text=True).stdout
                 for c in sorted(pathlib.Path(tmp).glob("*.cubin"))]
    return "\n".join(texts)


def library_counts(library: pathlib.Path, source: pathlib.Path = SRC) -> dict:
    """``count`` of a built library against the source it was built
    from, keyed by the kernel's template flags joined by ``/``."""
    counts = count(disassemble(library), source.read_text(), source.name)
    return {"/".join(str(int(f)) for f in template_flags(k)): v
            for k, v in counts.items()}


def main(argv=None) -> dict:
    from repro_torch.kernels.photon_step import photon_step as K
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=0)
    args = ap.parse_args(argv)
    out = library_counts(K.build_library(args.groups))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

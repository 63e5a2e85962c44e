"""The port's lint (``repro_torch.lint``): every rule on fixture trees,
the port's own tree, and the engine against the reference's
(``repro.lint``) on the same inputs.

Every AST rule has a fixture it fires on and one it stays quiet on.
The mirror (REP101) and shared-memory (REP501) fixtures copy the real
mirror files into a temporary tree and break one line.  The traced
rules run on hand-made recordings (and REP804 on the real wrapper and
plain version); the traced tier's own targets run on the port's tree.
"""

import ast
import json
import pathlib
import shutil
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import lint as L  # noqa: E402
from repro_torch.lint import baseline as B  # noqa: E402
from repro_torch.lint.__main__ import main as lint_main  # noqa: E402
from repro_torch.lint.traced import (Op, Recorder, Recording,  # noqa: E402
                                     TraceTarget, load_allowlist,
                                     run_traced_lint)
from repro_torch.lint.traced import rules as TR  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = "src/repro_torch/kernels/photon_step"
MIRRORS = (f"{PKG}/spec.py", f"{PKG}/ops.py", f"{PKG}/photon_step.py",
           f"{PKG}/photon_step_cpu.py", f"{PKG}/ref.py",
           "src/repro_torch/core/simulator.py", L.KERNEL_SOURCE,
           L.HOST_KERNEL_SOURCE)


def _tree(tmp_path, files: dict, copy=()) -> pathlib.Path:
    """A fixture tree: ``copy`` taken from the repo, ``files`` written
    (a value is text, or ``(path to copy, [(old, new), ...])``)."""
    root = tmp_path / "tree"
    for rel in copy:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, root / rel)
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        if isinstance(text, tuple):
            src, edits = text
            text = (REPO / src).read_text()
            for old, new in edits:
                assert old in text, old
                text = text.replace(old, new)
        (root / rel).write_text(textwrap.dedent(text) if isinstance(
            text, str) and text.startswith("\n") else text)
    return root


def _rule(root, rule_id):
    return L.run_lint(root, rule_ids=[rule_id]).findings


# ---------------------------------------------------------------------------
# REP101 mirror-drift
# ---------------------------------------------------------------------------

MIRROR_BREAKS = {
    "ref appends": (f"{PKG}/ref.py",
                    [("out = out + (capd, capg)", "out = out + (capd,)")]),
    "kernel out slots": (L.KERNEL_SOURCE, [(
        "grp.cap_det = (int32_t*)out[i_out++];\n"
        "    grp.cap_gate = (int32_t*)out[i_out++];",
        "grp.cap_gate = (int32_t*)out[i_out++];\n"
        "    grp.cap_det = (int32_t*)out[i_out++];")]),
    "kernel first slot": (L.KERNEL_SOURCE, [("int i_in = 11, i_out = 12",
                                             "int i_in = 11, i_out = 13")]),
    "host kernel out slots": (L.HOST_KERNEL_SOURCE, [(
        "a.cap_det = (int32_t*)out[i_out++];\n"
        "    a.cap_gate = (int32_t*)out[i_out++];",
        "a.cap_gate = (int32_t*)out[i_out++];\n"
        "    a.cap_det = (int32_t*)out[i_out++];")]),
    "host kernel in slots": (L.HOST_KERNEL_SOURCE, [(
        "a.jac_w = (const float*)in[i_in++];\n"
        "    a.jac_col = (const int32_t*)in[i_in++];",
        "a.jac_col = (const int32_t*)in[i_in++];\n"
        "    a.jac_w = (const float*)in[i_in++];")]),
    "host kernel entry point": (L.HOST_KERNEL_SOURCE, [(
        "int photon_step_cpu_launch(", "int photon_step_host_launch(")]),
    "host signature": (f"{PKG}/photon_step_cpu.py", [(
        "def photon_step_host(labels_flat, media,",
        "def photon_step_host(labels, media,")]),
    "wrapper in slots": (f"{PKG}/photon_step.py",
                         [("ins += [jac_w, jac_col]",
                           "ins += [jac_col, jac_w]")]),
    "wrapper out slots": (f"{PKG}/photon_step.py", [(
        "outs += [torch.empty((n_all,), **i32), torch.empty((n_all,), "
        "**i32)]", "outs += [torch.empty((n_all,), **i32)]")]),
    "round loop unpack": ("src/repro_torch/core/simulator.py",
                          [("cur += 3", "cur += 2")]),
    "signature": (f"{PKG}/ops.py", [("def photon_steps(labels_flat, media,",
                                     "def photon_steps(labels, media,")]),
}


@pytest.mark.parametrize("name", sorted(MIRROR_BREAKS))
def test_mirror_fires_on_each_broken_mirror(tmp_path, name):
    path, edits = MIRROR_BREAKS[name]
    root = _tree(tmp_path, {path: (path, edits)},
                 copy=[m for m in MIRRORS if m != path])
    found = _rule(root, "REP101")
    assert found and all(f.rule == "REP101" for f in found), name


def test_mirror_is_quiet_on_the_real_mirrors(tmp_path):
    assert _rule(_tree(tmp_path, {}, copy=MIRRORS), "REP101") == []


def test_mirror_is_silent_without_a_spec(tmp_path):
    root = _tree(tmp_path, {"src/repro_torch/x.py": "y = 1\n"})
    assert _rule(root, "REP101") == []


# ---------------------------------------------------------------------------
# REP201 determinism, REP301 dtype, REP401 host reads
# ---------------------------------------------------------------------------

TRACED = "src/repro_torch/core/simulator.py"


@pytest.mark.parametrize("code", [
    "import random\nx = random.random()\n",
    "import numpy as np\nx = np.random.rand(3)\n",
    "import torch\nx = torch.rand(3)\n",
    "import torch\ng = torch.Generator()\n",
    "import time\nt = time.perf_counter()\n",
    "for x in {1, 2}:\n    pass\n",
    "import torch\ng = torch.zeros(3)\ng.index_add_(0, i, v * 2.0)\n",
    "import torch\ng.index_put_((i,), v, accumulate=True)\n",
], ids=["random", "numpy.random", "torch.rand", "generator", "clock",
        "set", "float index_add_", "accumulate index_put_"])
def test_determinism_fires(tmp_path, code):
    found = _rule(_tree(tmp_path, {TRACED: code}), "REP201")
    assert len(found) == 1 and found[0].path == TRACED


def test_determinism_is_quiet_on_fixed_point_sums_and_pragmas(tmp_path):
    code = ("import time\nimport torch\n"
            "g.index_add_(0, i, to_fixed(v, 36))\n"
            "g.index_add_(0, i, v.to(torch.int64))\n"
            "g.index_put_((i,), v)\n"
            "for x in sorted({1, 2}):\n    pass\n"
            "t = time.perf_counter()  # reprolint: disable=REP201 - a wall\n")
    assert _rule(_tree(tmp_path, {TRACED: code}), "REP201") == []
    # outside the traced closure the rule does not look
    root = _tree(tmp_path / "b", {"src/repro_torch/launch/x.py":
                                  "import random\nx = random.random()\n"})
    assert _rule(root, "REP201") == []


@pytest.mark.parametrize("cu,n", [
    ("__device__ void f(u64* p, float v) {\n  atomicAdd(p, v);\n}\n", 1),
    ("__device__ void f(float* p) {\n  atomicAdd(p, (float)1);\n}\n", 1),
    ("__device__ void f(u64* p, u64 u) {\n  atomicAdd(p, u);\n}\n"
     "// atomicAdd(p, v) in a comment\n", 0),
], ids=["float value", "float cast", "u64"])
def test_determinism_reads_the_kernels_atomics(tmp_path, cu, n):
    root = _tree(tmp_path, {L.KERNEL_SOURCE: cu})
    assert len(_rule(root, "REP201")) == n


def test_the_real_kernel_adds_only_integers(tmp_path):
    assert _rule(_tree(tmp_path, {}, copy=[L.KERNEL_SOURCE]),
                 "REP201") == []


@pytest.mark.parametrize("cpp,n", [
    ("void f(int64_t* p, float v) {\n"
     "  __atomic_fetch_add(p, v, __ATOMIC_RELAXED);\n}\n", 1),
    ("void f(float* p) {\n"
     "  __atomic_add_fetch(p, (float)1, __ATOMIC_RELAXED);\n}\n", 1),
    ("void f(uint64_t* p, int64_t u) {\n"
     "  __atomic_fetch_add(p, (uint64_t)u, __ATOMIC_RELAXED);\n"
     "  __atomic_fetch_add(p, 1LL, __ATOMIC_RELAXED);\n"
     "  __atomic_fetch_or(p, 1, __ATOMIC_RELAXED);\n}\n"
     "// __atomic_fetch_add(p, v, 0) in a comment\n", 0),
], ids=["float value", "float cast", "uint64"])
def test_determinism_reads_the_host_kernels_atomics(tmp_path, cpp, n):
    found = _rule(_tree(tmp_path, {L.HOST_KERNEL_SOURCE: cpp}), "REP201")
    assert len(found) == n
    assert all(f.path == L.HOST_KERNEL_SOURCE for f in found)


def test_the_real_host_kernel_adds_only_integers(tmp_path):
    assert _rule(_tree(tmp_path, {}, copy=[L.HOST_KERNEL_SOURCE]),
                 "REP201") == []


@pytest.mark.parametrize("code", [
    "import torch\nx = torch.zeros(3, dtype=torch.float64)\n",
    "import numpy as np\nx = np.float64(1)\n",
    "y = x.double()\n",
    "import numpy as np\nx = np.zeros(3, dtype=float)\n",
    "import numpy as np\nx = np.asarray(v, float)\n",
], ids=["torch.float64", "np.float64", ".double()", "dtype=float",
        "bare float"])
def test_dtype_fires(tmp_path, code):
    found = _rule(_tree(tmp_path, {"src/repro_torch/m.py": code}), "REP301")
    assert len(found) == 1


def test_dtype_is_quiet_on_float32_and_pragmas_and_reads_the_kernel(
        tmp_path):
    code = ("import torch\nx = torch.zeros(3, dtype=torch.float32)\n"
            "y = x.to(torch.float64)  # reprolint: disable=REP301 - host\n")
    root = _tree(tmp_path, {"src/repro_torch/m.py": code,
                            L.KERNEL_SOURCE: "float a; // double in a "
                            "comment\n"})
    assert _rule(root, "REP301") == []
    root = _tree(tmp_path / "b", {L.KERNEL_SOURCE: "double a = 1.0;\n"})
    assert [f.line for f in _rule(root, "REP301")] == [1]


def test_dtype_reads_the_host_kernel(tmp_path):
    root = _tree(tmp_path, {L.HOST_KERNEL_SOURCE:
                            "float a;  // double in a comment\n"
                            "static double b = 1.0;\n"})
    found = _rule(root, "REP301")
    assert [(f.path, f.line) for f in found] == [(L.HOST_KERNEL_SOURCE, 2)]
    assert _rule(_tree(tmp_path / "b", {}, copy=[L.HOST_KERNEL_SOURCE]),
                 "REP301") == []


ROUND = """
def build_round_loop(cfg):
    def fn(state, cancel=None):
        while True:
            if not bool(state.any()):  # reprolint: disable=REP401 - read
                break
            {extra}
    return fn
"""


@pytest.mark.parametrize("extra", ["n = state.sum().item()",
                                   "x = state.cpu()", "k = int(state[0])",
                                   "torch.cuda.synchronize()",
                                   "v = state.tolist()"])
def test_host_reads_in_the_round_fire(tmp_path, extra):
    code = "import torch\n" + textwrap.dedent(ROUND).format(extra=extra)
    found = _rule(_tree(tmp_path, {TRACED: code}), "REP401")
    assert len(found) == 1 and "round loop" in found[0].message


GRAPHED_ROUND = """
def build_round_loop(cfg):
    def fn(state, cancel=None):
        def work():
            {inner}

        def one_round():
            work()

        def unused():
            return int(state.sum())
        while True:
            if not bool(state.any()):  # reprolint: disable=REP401 - read
                break
            for _ in range(4):
                one_round()
    return fn
"""


@pytest.mark.parametrize("inner,n", [("return state.sum().item()", 1),
                                     ("state.add_(1)", 0)])
def test_host_reads_in_the_functions_a_round_calls_fire(tmp_path, inner, n):
    """The round the loop calls (and what that calls in turn) is part of
    the round: a graph captures it, so it may not read the host; a nested
    function the loop never calls is not."""
    code = "import torch\n" + textwrap.dedent(GRAPHED_ROUND).format(
        inner=inner)
    found = _rule(_tree(tmp_path, {TRACED: code}), "REP401")
    assert len(found) == n
    assert all("round loop" in f.message for f in found)


def test_host_reads_outside_the_round_are_quiet(tmp_path):
    code = ("import torch\n" + textwrap.dedent(ROUND).format(
        extra="state = state + 1") + "\nn = int(state.sum())\n")
    assert _rule(_tree(tmp_path, {TRACED: code}), "REP401") == []
    found = _rule(_tree(tmp_path / "b", {TRACED: "x = 1\n"}), "REP401")
    assert len(found) == 1 and "not found" in found[0].message


# ---------------------------------------------------------------------------
# REP501 shared memory, REP601 reachability, REP701 bench schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edits,what", [
    ([("constexpr int kCacheLog2 = 10;", "constexpr int kCacheLog2 = 12;")],
     "over the"),
    ([("__shared__ int s_order[kThreads];",
       "__shared__ int s_order[kThreads];\n  __shared__ float s_x[64];")],
     "no longer mirrors"),
    ([("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
     "the wrapper's"),
], ids=["past the limit", "formula", "wrapper constants"])
def test_shared_memory_fires(tmp_path, edits, what):
    root = _tree(tmp_path, {L.KERNEL_SOURCE: (L.KERNEL_SOURCE, edits)},
                 copy=[f"{PKG}/photon_step.py"])
    found = _rule(root, "REP501")
    assert any(what in f.message for f in found), found


def test_shared_memory_is_quiet_on_the_real_kernel(tmp_path):
    from repro_torch.kernels.photon_step import spec
    root = _tree(tmp_path, {}, copy=[L.KERNEL_SOURCE,
                                     f"{PKG}/photon_step.py"])
    assert _rule(root, "REP501") == []
    # what ptxas reports for the kernel that appends the round's records:
    # "13508 bytes smem" (the step kernel leaves the 32-byte capture mask
    # out: 13476)
    assert spec.check_shared(256, 1024) == 13508 <= spec.SHARED_LIMIT
    with pytest.raises(ValueError, match="limit"):
        spec.check_shared(256, 4096)


def test_reachability(tmp_path):
    files = {"src/repro_torch/__init__.py": "",
             "src/repro_torch/launch/run.py":
                 "from repro_torch import used\n",
             "src/repro_torch/used.py": "x = 1\n",
             "src/repro_torch/tested.py": "x = 1\n",
             "tests/test_torch_x.py": "import repro_torch.tested\n",
             "src/repro_torch/orphan.py": "x = 1\n"}
    found = _rule(_tree(tmp_path, files), "REP601")
    assert [f.path for f in found] == ["src/repro_torch/orphan.py"]
    del files["src/repro_torch/orphan.py"]
    assert _rule(_tree(tmp_path / "b", files), "REP601") == []


@pytest.mark.parametrize("body,n", [
    ("json.dumps({'a': 1})", 1),
    ("json.dumps({'schema_version': 3})", 1),
    ("json.dumps({'schema_version': SCHEMA_VERSION})", 0),
], ids=["unstamped", "literal", "constant"])
def test_bench_schema(tmp_path, body, n):
    code = f"import json\nOUT = 'BENCH_x.json'\ns = {body}\n"
    root = _tree(tmp_path, {"src/repro_torch/launch/bench.py": code})
    assert len(_rule(root, "REP701")) == n


# ---------------------------------------------------------------------------
# the engine: pragmas, baseline, CLI, and the reference's engine
# ---------------------------------------------------------------------------

LINES = ["x = np.float64(1)  # reprolint: disable=REP301 - host",
         "y = f('a # b')  # trailing",
         "  z  =  1  ",
         "s = \"it's\"  # reprolint: disable=REP201,REP301 - two",
         "# reprolint: disable=all",
         "w = 2 # reprolint:disable=REP101"]


def test_pragmas_and_normalized_lines_match_the_reference():
    ref = pytest.importorskip("repro.lint")
    for line in LINES:
        assert L.normalize_line(line) == ref.normalize_line(line), line
        assert L.pragma_rules(line) == ref.pragma_rules(line), line
    assert L.pragma_rules("double a;  // reprolint: disable=REP301 - x") \
        == {"REP301"}


def test_fingerprints_and_baselines_match_the_reference(tmp_path):
    ref = pytest.importorskip("repro.lint")
    ref_base = pytest.importorskip("repro.lint.baseline")
    code = "import numpy as np\nx = np.float64(1)\n"
    root = _tree(tmp_path, {"src/repro/m.py": code,
                            "src/repro_torch/m.py": code})
    want = ref.run_lint(root, rule_ids=["REP301"]).findings
    got = L.run_lint(root, rule_ids=["REP301"]).findings
    assert len(want) == 1 and len(got) == 1
    line = code.splitlines()[1]
    assert L.fingerprint(want[0].rule, want[0].path, line) == \
        want[0].fingerprint
    assert got[0].fingerprint == L.fingerprint("REP301", got[0].path, line)
    # each writes a baseline the other reads, in one format
    ref_base.save_baseline(tmp_path / "ref.json",
                           ref.run_lint(root, rule_ids=["REP301"]))
    B.save_baseline(tmp_path / "port.json",
                    L.run_lint(root, rule_ids=["REP301"]))
    a, b = (json.loads((tmp_path / n).read_text())
            for n in ("ref.json", "port.json"))
    assert set(a) == set(b) and a["version"] == b["version"]
    assert B.load_baseline(tmp_path / "ref.json") == \
        ref_base.load_baseline(tmp_path / "ref.json")
    assert ref_base.load_baseline(tmp_path / "port.json") == \
        {got[0].fingerprint: 1}
    report = L.run_lint(root, rule_ids=["REP301"],
                        baseline=B.load_baseline(tmp_path / "port.json"))
    assert report.clean and report.suppressed_baseline == 1


def test_the_spec_groups_and_params_match_the_reference():
    from repro_torch.lint.astutil import load_literal_constants
    from repro_torch.kernels.photon_step import spec
    consts = load_literal_constants(ast.parse(
        (REPO / "src/repro/kernels/photon_step/spec.py").read_text()))
    for name in ("OUTPUT_GROUPS", "CORE_PARAMS", "EXT_PARAMS",
                 "BASE_OUTPUTS", "STATE_FIELDS"):
        assert getattr(spec, name) == consts[name], name


def test_cli_exit_codes_formats_and_rule_list(tmp_path, capsys):
    bad = _tree(tmp_path, {"src/repro_torch/m.py":
                           "import torch\nx = torch.float64\n"})
    assert lint_main(["--root", str(bad), "--rules", "REP301"]) == 1
    assert "REP301[dtype]" in capsys.readouterr().out
    assert lint_main(["--root", str(bad), "--rules", "REP301",
                      "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["clean"] is False
    assert lint_main(["--root", str(bad), "--rules", "REP301",
                      "--format", "github"]) == 1
    assert "::error file=src/repro_torch/m.py" in capsys.readouterr().out
    assert lint_main(["--root", str(bad), "--write-baseline"]) == 0
    assert lint_main(["--root", str(bad), "--rules", "REP301"]) == 0
    assert lint_main(["--root", str(tmp_path / "none")]) == 2
    assert lint_main(["--list-rules", "--tier", "all"]) == 0
    listed = capsys.readouterr().out
    assert all(f"REP{n}01" in listed for n in range(1, 9))


# ---------------------------------------------------------------------------
# the traced tier
# ---------------------------------------------------------------------------

def _op(name, dtype="torch.float32", **kw):
    return Op(name=name, dtypes=(dtype,), shapes=((4,),), devices=("cpu",),
              **kw)


STEP = _op("repro_torch::photon_step")
READ = _op("aten::_local_scalar_dense", "torch.bool")


def _target(ops, variants=None, make=None, name="t"):
    rec = Recording(list(ops))
    return TraceTarget(name, "src/repro_torch/x.py",
                       make or (lambda overrides=None: rec),
                       variants or {})


def _traced(rule, targets):
    return list(rule().check(targets))


@pytest.mark.parametrize("rule,bad,good", [
    (TR.TracedDtypeRule, [_op("aten::mul.Tensor", "torch.float64")],
     [_op("aten::mul.Tensor"), _op("aten::add.Tensor", "torch.int64"),
      _op("aten::mul.Tensor", "torch.float64", in_step=True)]),
    (TR.ScatterRaceRule, [_op("aten::index_add_", in_step=True)],
     [_op("aten::index_add_", "torch.int64", in_step=True),
      _op("aten::index_put_", bools=())]),
    (TR.ScatterRaceRule, [_op("aten::index_put_", bools=(True,))], []),
    (TR.HostSyncRule, [STEP, READ, READ, STEP],
     [STEP, READ, _op("aten::add.Tensor"), STEP, READ, STEP]),
], ids=["REP801", "REP802", "REP802 put", "REP803"])
def test_traced_rules_fire_and_stay_quiet(rule, bad, good):
    assert len(_traced(rule, [_target(bad)])) == 1
    assert _traced(rule, [_target(good)]) == []


def test_engine_parity_fires_on_a_mismatch(monkeypatch):
    real = TR.parity
    assert _traced(TR.EngineParityRule, []) == []  # every mask, real
    got, want = real(15, 2)
    assert len(got) == len(want) == 8 + 4 + 3 + 2 + 1 + 1
    monkeypatch.setattr(TR, "parity", lambda g, s: (
        [((1,), torch.int64)], [((1,), torch.int32)]))
    found = _traced(TR.EngineParityRule, [])
    assert found and "output 0" in found[0].message


def test_recompile_churn():
    steady = [STEP, _op("aten::add.Tensor"), READ, STEP,
              _op("aten::add.Tensor"), READ, STEP]
    other = [STEP, _op("aten::mul.Tensor"), READ, STEP]
    same = _target(steady, {"seed": {"seed": 1}})
    assert _traced(TR.RecompileChurnRule, [same]) == []
    churn = _target(steady, {"seed": {"seed": 1}},
                    make=lambda o=None: Recording(steady if o is None
                                                  else other))
    found = _traced(TR.RecompileChurnRule, [churn])
    assert len(found) == 1 and "`seed`" in found[0].message
    uneven = _target([STEP, _op("aten::add.Tensor"), STEP, STEP],
                     {"seed": {}})
    assert "differ" in _traced(TR.RecompileChurnRule, [uneven])[0].message


def test_recompile_churn_leaves_out_reads_every_few_rounds():
    """A loop that reads the host before every few rounds has steady
    rounds: the rounds' device operations are compared, and the reads
    are REP803's."""
    add = _op("aten::add.Tensor")
    ops = [STEP, add, STEP, add, READ, STEP, add, STEP, add, READ, STEP]
    target = _target(ops, {"seed": {"seed": 1}})
    assert _traced(TR.RecompileChurnRule, [target]) == []
    assert _traced(TR.HostSyncRule, [target]) == []
    assert Recording(ops).per_round()["host_reads"] == [0, 1, 0, 1]


def test_recorder_marks_steps_rounds_and_host_reads():
    rec = Recorder()
    step = rec.step(lambda x: (x * 2).sum())
    with rec:
        x = torch.ones(4)
        for _ in range(3):
            step(x)
            x = x + 1
            bool(x.any())
    r = rec.recording()
    rounds = r.per_round()
    assert rounds["rounds"] == 2 and rounds["host_reads"] == [1, 1]
    assert rounds["device_ops"] == [3, 3]  # the step, add, any
    assert [op.name for op in r.ops if op.in_step] == []  # not recorded


def test_allow_file_needs_a_why_and_a_max(tmp_path):
    path = tmp_path / "allow.json"
    for entry in ({"rule": "REP801", "max": 1},
                  {"rule": "REP801", "why": "x"},
                  {"rule": "REP801", "why": " ", "max": 1}):
        path.write_text(json.dumps({"version": 1, "allow": [entry]}))
        with pytest.raises(ValueError):
            load_allowlist(path)
    entry = {"rule": "REP801", "target": "t", "match": "float64",
             "max": 1, "why": "the test"}
    path.write_text(json.dumps({"version": 1, "allow": [entry]}))
    bad = _target([_op("aten::mul.Tensor", "torch.float64"),
                   _op("aten::add.Tensor", "torch.float64")])
    rep = run_traced_lint(tmp_path, targets=[bad], rules=[
        TR.TracedDtypeRule()], allowlist=load_allowlist(path))
    assert rep.suppressed_pragma == 1 and len(rep.findings) == 1


def test_a_target_that_raises_is_a_finding(tmp_path):
    def boom(overrides=None):
        raise RuntimeError("no")
    rep = run_traced_lint(tmp_path, targets=[_target([], make=boom)],
                          rules=[])
    assert [f.rule for f in rep.findings] == ["REP800"]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

def test_the_ports_tree_is_clean_in_both_tiers():
    """``python -m repro_torch.lint --tier all`` on the tree: every
    pragma carries a why, every allow entry is used, and the traced
    ``sim`` target reads the host once every ``ROUNDS_PER_READ``
    rounds."""
    from repro_torch.core import simulator as S

    ast_rep = L.run_lint(REPO, baseline=B.load_baseline(
        B.baseline_path(REPO)))
    assert ast_rep.clean, [f.format() for f in ast_rep.findings]
    for mod in L.discover_modules(REPO).values():
        for line in mod.lines:
            if L.pragma_rules(line):
                assert " - " in line.split("reprolint:")[1], line
    from repro_torch.lint.traced import allowlist_path
    from repro_torch.lint.traced.targets import build_default_targets
    allow = load_allowlist(allowlist_path(REPO))
    targets = build_default_targets()
    rep = run_traced_lint(REPO, targets=targets, allowlist=allow)
    assert rep.clean, [f.format() for f in rep.findings]
    assert rep.suppressed_pragma == sum(e["max"] for e in allow)
    sim = next(t for t in targets if t.name == "sim").recording()
    rounds = sim.per_round()
    # the loop reads the host before every ROUNDS_PER_READ rounds: in the
    # gap after each ROUNDS_PER_READ-th step, and in no other
    every = S.ROUNDS_PER_READ
    assert rounds["rounds"] > every
    assert [i for i, n in enumerate(rounds["host_reads"]) if n] == list(
        range(every - 1, rounds["rounds"], every))
    assert max(rounds["host_reads"]) == 1
    assert len(set(rounds["device_ops"])) == 1

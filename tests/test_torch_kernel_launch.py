"""The photon-step wrapper's launch plan, argument packing and size
limits, and the SASS counter's parsing, on the CPU.

The CUDA entry point (``csrc/photon_step.cu``, ``photon_step_launch``)
documents the order of its ``in``, ``out``, ``ints`` and ``floats``
arrays in a comment; these tests read that comment and hold
``photon_step.prepare`` and ``photon_step.pack`` to it, so the contract
and the wrapper cannot drift apart without a card to show it.
"""

import array
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import volume as V  # noqa: E402
from repro_torch.detectors import as_detectors, det_geometry  # noqa: E402
from repro_torch.kernels.photon_step import ops, sass  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as K  # noqa: E402

SHAPE = (12, 10, 8)
N = 300


def _entry_point_contract() -> dict[str, list[str]]:
    """The names in the C entry point's comment, by array."""
    text = K._SRC.read_text()
    doc = text[text.index("// Plain C entry point"):
               text.index('extern "C" int photon_step_launch')]
    doc = " ".join(ln.strip().lstrip("/").strip() for ln in doc.splitlines())
    out = {}
    for key, nxt in (("in:", "out:"), ("out:", "ints:"), ("ints:", "floats:"),
                     ("floats:", "Returns")):
        part = doc[doc.index(key) + len(key):doc.index(nxt)]
        part = re.sub(r";[^\]]*?(?=\])", "", part)  # notes inside brackets
        part = re.sub(r"\((DET|JAC|RECORD|STATS|\d+)\)", "", part)
        part = part.split(";")[0]
        out[key[:-1]] = [w for w in re.findall(r"[a-z_]+", part)
                         if w not in ("then", "and", "fluence_exitance")]
    return out


def _call(groups=("det", "record", "jac", "stats"), n=N, n_media=None):
    vol = V.benchmark_b2(SHAPE)
    if n_media is not None:
        vol = V.volume_from_arrays(vol.labels.numpy(),
                                   torch.cat([vol.media] + [vol.media[-1:]] * (
                                       n_media - vol.media.shape[0])).numpy())
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4)
    state = ops.fresh_state(vol, n, seed=2)
    kw = {}
    if "det" in groups:
        kw.update(ppath=torch.zeros(n, vol.media.shape[0]),
                  det_geom=det_geometry(as_detectors([(6.0, 5.0, 2.0)])))
    if "record" in groups:
        kw["record"] = True
    if "jac" in groups:
        kw.update(jac_w=torch.ones(n), jac_cols=3,
                  jac_col=torch.zeros(n, dtype=torch.int32))
    if "stats" in groups:
        kw["stats"] = True
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 0.5, cfg, 7)
    return vol, cfg, state, kw, args


@pytest.mark.parametrize("n", [0, 1, 31, K.THREADS - 1, K.THREADS,
                               K.THREADS + 1, 4 * K.THREADS + 77])
def test_launch_shape_covers_every_lane_once(n):
    _, _, _, _, args = _call(groups=(), n=n)
    ints = dict(zip(_entry_point_contract()["ints"], K.prepare(*args)[3]))
    assert ints["n"] == n and ints["threads"] == K.THREADS
    assert ints["blocks"] * K.THREADS >= n
    assert (ints["blocks"] - 1) * K.THREADS < max(n, 1)


def test_prepare_orders_arguments_as_the_entry_point_documents():
    contract = _entry_point_contract()
    assert contract["ints"][-2:] == ["threads", "blocks"]
    vol, cfg, state, kw, args = _call()
    groups, ins, outs, ints, floats = K.prepare(*args, **kw)
    assert groups == 15
    # inputs: the documented names, each the caller's tensor
    given = {"labels": args[0], "media": args[1], **state._asdict(),
             "ppath": kw["ppath"], "det_geom": kw["det_geom"],
             "jac_w": kw["jac_w"], "jac_col": kw["jac_col"]}
    assert len(ins) == len(contract["in"]) == 15
    for name, x in zip(contract["in"], ins):
        if name == "errors":
            assert x.dtype == torch.int32 and x.shape == (1,)
        else:
            assert x is given[name], name
    # outputs: dtypes and shapes of the documented names, in order
    nvox, ntg, n_media = vol.labels.numel(), cfg.n_time_gates, \
        vol.media.shape[0]
    want = {"pos": (torch.float32, (N, 3)), "dir": (torch.float32, (N, 3)),
            "ivox": (torch.int32, (N, 3)), "w": (torch.float32, (N,)),
            "s_left": (torch.float32, (N,)), "t": (torch.float32, (N,)),
            "rng": (torch.int64, (N, 4)), "alive": (torch.bool, (N,)),
            "fluence": (torch.float32, (nvox * ntg,)),
            "exitance": (torch.float32, (SHAPE[0] * SHAPE[1],)),
            "escaped": (torch.float32, (N,)), "timed": (torch.float32, (N,)),
            "ppath": (torch.float32, (N, n_media)),
            "det_w": (torch.float32, (ntg,)),
            "det_ppath": (torch.float32, (1, n_media)),
            "cap_det": (torch.int32, (N,)), "cap_gate": (torch.int32, (N,)),
            "jac": (torch.float32, (nvox * 3,)),
            "stats": (torch.float32, (N, 2))}
    assert contract["out"] == list(want)
    for name, x in zip(contract["out"], outs):
        assert (x.dtype, tuple(x.shape)) == want[name], name
    # scalars, by their documented names
    named = dict(zip(contract["ints"], ints))
    assert named == {
        "n": N, "nx": 12, "ny": 10, "nz": 8, "n_steps": 7, "ntg": 4,
        "general_exact": 0, "do_reflect": 1, "taylor": 0, "groups": 15,
        "n_det": 1, "n_media": n_media, "jac_cols": 3,
        "threads": K.THREADS, "blocks": 2}
    assert contract["floats"] == ["unit", "gate_scale", "tmax",
                                  "w_threshold", "roulette_m", "roulette_p"]
    assert floats[0] == 0.5 and floats[2] == cfg.tmax_ns
    assert floats[5] == pytest.approx(1.0 / cfg.roulette_m)


def test_pack_gives_the_entry_point_its_four_arrays():
    _, _, _, kw, args = _call(groups=("det", "stats"))
    _, ins, outs, ints, floats = K.prepare(*args, **kw)
    p_in, p_out, p_ints, p_floats = K.pack(ins, outs, ints, floats)
    assert (p_in.typecode, p_out.typecode, p_ints.typecode,
            p_floats.typecode) == ("Q", "Q", "i", "f")
    assert p_in.itemsize == p_out.itemsize == 8
    assert p_ints.itemsize == p_floats.itemsize == 4
    assert list(p_in) == [x.data_ptr() for x in ins]
    assert list(p_out) == [x.data_ptr() for x in outs]
    assert list(p_ints) == list(ints)
    assert list(p_floats) == list(array.array("f", floats))


@pytest.mark.parametrize("n_media", [3, 6, 40])
def test_prepare_sizes_ppath_by_the_media_table(n_media):
    _, _, _, kw, args = _call(groups=("det",), n_media=n_media)
    _, ins, outs, ints, _ = K.prepare(*args, **kw)
    assert ints[11] == n_media
    assert ins[10].shape == outs[12].shape == (N, n_media)
    assert outs[14].shape == (1, n_media)


def test_prepare_raises_on_grids_beyond_the_cache_keys():
    _, cfg, _, _, args = _call(groups=())
    nvox, nxy = 12 * 10 * 8, 12 * 10
    # the most time gates whose fluence cells and exitance bins all have
    # an int32 cache key
    fits = (K.MAX_CELLS - 1 - nxy) // nvox
    with pytest.raises(ValueError, match="too large"):
        K.prepare(*args[:5], dataclasses.replace(cfg, n_time_gates=fits + 1),
                  7)
    # one gate fewer passes the size rule and reaches the input checks
    with pytest.raises(ValueError, match="labels_flat has shape"):
        K.prepare(args[0][:-1], *args[1:5],
                  dataclasses.replace(cfg, n_time_gates=fits), 7)
    with pytest.raises(ValueError, match="n_time_gates >= 1"):
        K.prepare(*args[:5], dataclasses.replace(cfg, n_time_gates=0), 7)
    with pytest.raises(ValueError, match="n_steps >= 0"):
        K.prepare(*args[:6], -1)


def test_prepare_checks_every_input():
    vol, cfg, state, kw, args = _call(groups=("det", "jac"))
    labels, media = args[0], args[1]
    with pytest.raises(TypeError, match="dtype"):
        K.prepare(labels, media, state._replace(w=state.w.double()),
                  *args[3:], **kw)
    with pytest.raises(ValueError, match="shape"):
        K.prepare(labels[:-1], *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.prepare(*args, **dict(kw, ppath=kw["ppath"].t().contiguous().t()))
    with pytest.raises(TypeError, match="dtype"):
        K.prepare(*args, **dict(kw, jac_col=kw["jac_col"].long()))
    with pytest.raises(TypeError, match="must be a tensor"):
        K.prepare(*args, **dict(kw, jac_w=[1.0] * N))


def test_plain_version_sums_its_grids_exactly_on_request():
    from repro_torch.kernels.photon_step.ref import photon_steps_ref
    vol, cfg, state, kw, args = _call(n=512)
    kw = dict(kw, jac_w=torch.rand(512, generator=torch.Generator(
        ).manual_seed(1)))
    f32 = photon_steps_ref(*args, **kw)
    f64 = photon_steps_ref(*args, **kw, accumulate=torch.float64)
    again = photon_steps_ref(*args, **kw, accumulate=torch.float32)
    grids = {1, 2, 6, 7, 10}  # fluence, exitance, TPSF, path sums, Jacobian
    for i, (a, b, c) in enumerate(zip(f32, f64, again)):
        if i == 0:
            for x, y, z in zip(a, b, c):
                assert torch.equal(x, y) and torch.equal(x, z)
        elif i in grids:
            assert b.dtype == torch.float64 and a.dtype == torch.float32
            assert torch.equal(a, c)
            torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6)
            assert i != 1 or float(b.sum()) > 0
        else:
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("module", ["kernel_timing", "profile_run"])
def test_measurement_entry_points_need_a_card(module, monkeypatch):
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main([])


# a made-up disassembly in nvdisasm's format: one kernel, a marker
# region each for the loop and the spin, a division slow path (cold)
_SOURCE = """\
void f() {
  // --- LOOP: top
  int a = 1;
  // --- SPIN: scatter
  float b = 2;
}
"""
_DISASM = """\
.text._ZN12_GLOBAL__N_118photon_step_kernelILb1ELb0ELb0EEEv4Args:
\t//## File "/x/k.cu", line 3
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R1, 0x3, RZ ;
\t//## File "/x/other.hpp", line 9 inlined at "/x/k.cu", line 5
        /*0020*/                   MUFU.RCP R3, R2 ;
        /*0030*/                   FCHK P0, R2, R3 ;
        /*0040*/              @!P0 BRA `(.L_x_1) ;
        /*0050*/                   MOV R38, 0x70 ;
        /*0060*/                   CALL.REL.NOINC `($slowpath) ;
.L_x_1:
\t//## File "/x/k.cu", line 5
        /*0070*/                   FADD R4, R3, 1 ;
        /*0072*/               @P1 BRA `(.L_x_3) ;
.L_x_2:
        /*0074*/                   LDS R8, [R15] ;
        /*0076*/                   ATOMS.CAST.SPIN R9, [R15], R8, R9 ;
        /*0078*/              @!P2 BRA `(.L_x_2) ;
.L_x_3:
        /*0080*/                   EXIT ;
$slowpath:
        /*0090*/                   FFMA R4, R3, R3, R3 ;
        /*00a0*/                   RET.REL.NODEC R38 ;
        /*00b0*/                   NOP;
"""


def test_sass_counts_by_region_with_cold_paths_apart():
    counts = sass.count(_DISASM, _SOURCE, "k.cu")
    (name, regions), = counts.items()
    assert sass.template_flags(name) == (True, False, False)
    assert regions["LOOP"] == {"hot": 2, "cold": 0}
    # MUFU, FCHK, BRA, FADD, the shared-memory retry loop and EXIT hot;
    # the call set-up and the subroutine after EXIT cold
    assert regions["SPIN"] == {"hot": 9, "cold": 4}
    assert sass.regions(_SOURCE) == [(2, "LOOP"), (4, "SPIN")]
    ms = sass.issue_ms(regions, {"LOOP": 1000, "SPIN": 10})
    assert ms == pytest.approx((2 * 1000 + 9 * 10) / sass.WARP_ISSUE_PER_S
                               * 1e3)

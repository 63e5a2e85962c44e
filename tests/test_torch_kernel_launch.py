"""The photon-step wrapper's launch plan, argument packing and size
limits, and the SASS counter's parsing, on the CPU.

The CUDA entry point (``csrc/photon_step.cu``, ``photon_step_launch``)
documents the order of its ``in``, ``out``, ``ints`` and ``floats``
arrays in a comment; these tests read that comment and hold
``photon_step.prepare`` and ``photon_step.pack`` to it, so the contract
and the wrapper cannot drift apart without a card to show it.  The
``tail`` and ``records`` arrays are held to ``RoundTail`` and
``RoundRecords`` the same way, and ``prepare`` refuses records it
cannot take.
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
            "fluence": (torch.int64, (nvox * ntg,)),
            "exitance": (torch.int64, (SHAPE[0] * SHAPE[1],)),
            "escaped": (torch.float32, (N,)), "timed": (torch.float32, (N,)),
            "ppath": (torch.float32, (N, n_media)),
            "det_w": (torch.int64, (ntg,)),
            "det_ppath": (torch.int64, (1, n_media)),
            "cap_det": (torch.int32, (N,)), "cap_gate": (torch.int32, (N,)),
            "jac": (torch.int64, (nvox * 3,)),
            "stats": (torch.float32, (N, 2))}
    assert contract["out"] == list(want)
    for name, x in zip(contract["out"], outs):
        assert (x.dtype, tuple(x.shape)) == want[name], name
    # scalars, by their documented names
    named = dict(zip(contract["ints"], ints))
    assert named == {
        "n": N, "nx": 12, "ny": 10, "nz": 8, "n_steps": 7, "ntg": 4,
        "general_exact": 0, "do_reflect": 1, "taylor": 0, "groups": 15,
        "n_det": 1, "n_media": n_media, "jac_cols": 3, "scenarios": 1,
        "labels_stride": 0, "add_into": 0, "threads": K.THREADS, "blocks": 2}
    assert contract["floats"] == ["unit", "gate_scale", "tmax",
                                  "w_threshold", "roulette_m", "roulette_p"]
    assert floats[0] == 0.5 and floats[2] == cfg.tmax_ns
    assert floats[5] == pytest.approx(1.0 / cfg.roulette_m)


def test_prepare_adds_each_replay_pass_into_its_totals():
    """The replay's two launches as the wrapper packs them: pass B (the
    Jacobian) adds into fluence, exitance and the int64 Jacobian, pass A
    (detectors and records) into fluence, exitance, TPSF and path sums;
    the output pointers are the caller's totals and add_into is set, so
    the kernel zeroes nothing.  Both masks are among the 12 libraries of
    ``VALID_GROUPS``."""
    vol, cfg, state, kw, args = _call(groups=("jac",))
    nvox, n_media = vol.labels.numel(), vol.media.shape[0]
    i64 = dict(dtype=torch.int64)
    flu = torch.zeros(nvox * 4, **i64)
    exi = torch.zeros(SHAPE[0] * SHAPE[1], **i64)
    jac = torch.zeros(nvox * 3, **i64)
    groups, ins, outs, ints, floats = K.prepare(*args, **kw,
                                                totals=[flu, exi, jac])
    assert groups == K.GROUP_BITS["jac_cols"] and ints[9] == groups
    assert K.group_names(groups) == "jac" and ints[15] == 1  # add_into
    assert outs[8] is flu and outs[9] is exi and outs[-1] is jac
    p_out = K.pack(ins, outs, ints, floats)[1]
    assert (p_out[8], p_out[9], p_out[-1]) == (
        flu.data_ptr(), exi.data_ptr(), jac.data_ptr())
    with pytest.raises(ValueError, match="totals must be"):
        K.prepare(*args, **kw, totals=[jac])
    _, _, _, dkw, dargs = _call(groups=("det", "record"))
    det = [flu, exi, torch.zeros(4, **i64), torch.zeros((1, n_media), **i64)]
    groups, _, outs, ints, _ = K.prepare(*dargs, **dkw, totals=det)
    assert K.group_names(groups) == "det+record" and ints[15] == 1
    assert all(outs[i] is x for i, x in zip((8, 9, 13, 14), det))
    assert len(K.VALID_GROUPS) == 12 and max(K.VALID_GROUPS) == 15


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


def _documented_tail() -> list[str]:
    """The names of the ``tail`` array in the CUDA entry point's
    comment."""
    text = K._SRC.read_text()
    doc = text[:text.index('extern "C" int photon_step_launch')]
    doc = doc[doc.rindex("// Plain C entry point"):]
    doc = " ".join(ln.strip().lstrip("/").strip() for ln in doc.splitlines())
    part = doc[doc.index("``tail`` is null"):]
    part = part[part.index(":") + 1:part.index(".")]
    return re.findall(r"[a-z_]+", part.split("(")[0])


def test_prepare_and_pack_give_the_round_tail_as_documented():
    """The CUDA entry point documents its ``tail`` array as
    ``RoundTail``'s fields in order, the kernel's ``kTailWords`` counts
    them, ``pack_tail`` packs their pointers in that order, and a call
    given a tail has null per-lane escaped and timed slots (the launch
    adds them into the tail instead); ``prepare`` checks the tail's
    tensors and refuses it on a launch of no lane."""
    fields = list(K.RoundTail._fields)
    assert _documented_tail() == fields
    assert re.search(rf"kTailWords = {len(fields)};", K._SRC.read_text())
    _, _, _, kw, args = _call(groups=("det",))
    i64 = dict(dtype=torch.int64)
    tail = K.round_tail(torch.zeros(1, **i64), torch.zeros(1, **i64),
                        torch.ones(1, **i64))
    assert [(x.dtype, tuple(x.shape)) for x in tail] == [
        (torch.int64, (1,)), (torch.int64, (1,)), (torch.int64, (1,)),
        (torch.bool, (1,)), (torch.bool, ()), (torch.int64, (1,)),
        (torch.int32, (2,))]
    _, ins, outs, ints, floats = K.prepare(*args, **kw, tail=tail)
    assert outs[10] is None and outs[11] is None
    assert all(x is not None for i, x in enumerate(outs) if i not in (10, 11))
    p_out = K.pack(ins, outs, ints, floats)[1]
    assert p_out[10] == p_out[11] == 0
    packed = K.pack_tail(tail)
    assert list(packed) == [x.data_ptr() for x in tail]
    assert K.tail_pointer(packed) == packed.buffer_info()[0]
    assert K.pack_tail(None) is None and K.tail_pointer(None) is None
    with pytest.raises(TypeError, match="tail.work has dtype"):
        K.prepare(*args, **kw, tail=tail._replace(
            work=torch.zeros(1, dtype=torch.uint8)))
    with pytest.raises(ValueError, match="tail.flags has shape"):
        K.prepare(*args, **kw, tail=tail._replace(
            flags=torch.zeros(1, dtype=torch.int32)))
    with pytest.raises(TypeError, match="RoundTail"):
        K.prepare(*args, **kw, tail=tuple(tail))
    _, _, _, _, none = _call(groups=(), n=0)
    with pytest.raises(ValueError, match="at least one lane"):
        K.prepare(*none, tail=tail)


def _documented_records() -> list[str]:
    """The names of the ``records`` array in the CUDA entry point's
    comment."""
    text = K._SRC.read_text()
    doc = text[:text.index('extern "C" int photon_step_launch')]
    doc = doc[doc.rindex("// Plain C entry point"):]
    doc = " ".join(ln.strip().lstrip("/").strip() for ln in doc.splitlines())
    part = doc[doc.index("``records`` is null"):]
    part = part[part.index(":") + 1:part.index(".")]
    return re.findall(r"[a-z_]+", part.split("(")[0])


def _records(S_=1, n=N, capacity=8, dev="cpu"):
    i64 = dict(dtype=torch.int64, device=dev)
    return K.RoundRecords(torch.zeros((S_, capacity + 1, 4), **i64),
                          torch.zeros(S_, **i64), torch.zeros(S_, **i64),
                          torch.zeros((S_ * n, 2), **i64),
                          *K.record_scratch(S_, n, dev))


def test_prepare_and_pack_give_the_round_records_as_documented():
    """The CUDA entry point documents its ``records`` array as
    ``RoundRecords``' fields in order and then the capacity, the
    kernel's ``kRecordWords`` counts them, ``record_scratch`` gives a
    zeroed int32 count a block and a staged row a lane of the blocks,
    and ``pack_records`` packs the pointers and the capacity; a call
    given records keeps its per-lane ``cap_det`` and ``cap_gate``
    outputs."""
    fields = list(K.RoundRecords._fields)
    assert _documented_records() == fields + ["capacity"]
    assert re.search(rf"kRecordWords = {len(fields) + 1};",
                     K._SRC.read_text())
    records = _records(capacity=5)
    blocks = -(-N // K.THREADS)
    assert (records.counts.dtype, records.counts.shape) == (torch.int32,
                                                            (blocks,))
    assert not records.counts.any()
    assert (records.rows.dtype, records.rows.shape) == (
        torch.int64, (blocks * K.THREADS, 4))
    counts, rows = K.record_scratch(3, N, "cpu")
    assert counts.shape == (3 * blocks,) and rows.shape == (
        3 * blocks * K.THREADS, 4)
    packed = K.pack_records(records)
    assert list(packed) == [x.data_ptr() for x in records] + [5]
    assert K.tail_pointer(packed) == packed.buffer_info()[0]
    assert K.pack_records(None) is None
    _, _, _, kw, args = _call(groups=("det", "record"))
    i64 = dict(dtype=torch.int64)
    tail = K.round_tail(torch.zeros(1, **i64), torch.zeros(1, **i64),
                        torch.ones(1, **i64))
    groups, _, outs, _, _ = K.prepare(*args, **kw, tail=tail,
                                      records=records)
    assert K.group_names(groups) == "det+record"
    assert [(x.dtype, tuple(x.shape)) for x in outs[15:17]] == [
        (torch.int32, (N,))] * 2


@pytest.mark.parametrize("case", [
    "no record group", "no tail", "not RoundRecords", "kept dtype",
    "counts dtype", "lane_ids shape", "rows shape", "no capacity",
    "rec shape", "device", "misaligned"])
def test_prepare_refuses_records_it_cannot_take(case):
    """Records need the RECORD group and a tail (whose last block
    appends them), int64 buffers of the launch's scenarios and lanes, a
    capacity of one row or more and the scratch ``record_scratch``
    makes, on the launch's device and 16-byte aligned."""
    groups = ("det",) if case == "no record group" else ("det", "record")
    _, _, _, kw, args = _call(groups=groups)
    i64 = dict(dtype=torch.int64)
    tail = K.round_tail(torch.zeros(1, **i64), torch.zeros(1, **i64),
                        torch.ones(1, **i64))
    rec = _records()
    bad = {
        "no record group": (rec, ValueError, "RECORD group"),
        "no tail": (rec, ValueError, "round's tail"),
        "not RoundRecords": (tuple(rec), TypeError, "RoundRecords"),
        "kept dtype": (rec._replace(kept=rec.kept.to(torch.int32)),
                       TypeError, "records.kept has dtype"),
        "counts dtype": (rec._replace(counts=rec.counts.long()), TypeError,
                         "records.counts has dtype"),
        "lane_ids shape": (rec._replace(lane_ids=rec.lane_ids[:-1]),
                           ValueError, "records.lane_ids has shape"),
        "rows shape": (rec._replace(rows=rec.rows[:-1]), ValueError,
                       "records.rows has shape"),
        "no capacity": (rec._replace(rec=rec.rec[:, :1]), ValueError,
                        "capacity of at least one"),
        "rec shape": (rec._replace(rec=rec.rec[..., :3]), ValueError,
                      "records.rec has shape"),
        "device": (rec._replace(overflow=torch.zeros(1, **i64,
                                                     device="meta")),
                   ValueError, "records.overflow is on meta"),
        "misaligned": (rec._replace(rows=torch.zeros(
            rec.rows.numel() + 1, dtype=torch.int64)[1:].view(-1, 4)),
            ValueError, "16-byte aligned"),
    }
    records, err, match = bad[case]
    with pytest.raises(err, match=match):
        K.prepare(*args, **kw, tail=None if case == "no tail" else tail,
                  records=records)


def test_the_host_kernel_takes_no_records():
    """On the CPU the round loop appends the records after the step: the
    dispatcher refuses records for the host kernel."""
    _, _, _, kw, args = _call(groups=("det", "record"))
    i64 = dict(dtype=torch.int64)
    tail = K.round_tail(torch.zeros(1, **i64), torch.zeros(1, **i64),
                        torch.ones(1, **i64))
    with pytest.raises(ValueError, match="host kernel appends no records"):
        ops.photon_steps(*args, **kw, tail=tail, records=_records())


@pytest.mark.parametrize("n_media", [3, 6, 40])
def test_prepare_sizes_ppath_by_the_media_table(n_media):
    _, _, _, kw, args = _call(groups=("det",), n_media=n_media)
    _, ins, outs, ints, _ = K.prepare(*args, **kw)
    assert ints[11] == n_media
    assert ins[11].shape == outs[12].shape == (N, n_media)
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
    """Every grid of the plain version, the Jacobian too, is an int64 sum
    of deposits each rounded once (``to_fixed``): the Jacobian equals
    the sum of its rounded deposits added in another order, and the
    call's totals are added into in place."""
    from repro_torch.core import photon as ph
    from repro_torch.core.fixed import to_fixed
    from repro_torch.kernels.photon_step import spec
    from repro_torch.kernels.photon_step.ref import photon_steps_ref
    vol, cfg, state, kw, args = _call(n=512)
    kw = dict(kw, jac_w=torch.rand(512, generator=torch.Generator(
        ).manual_seed(1)))
    got = photon_steps_ref(*args, **kw)
    again = photon_steps_ref(*args, **kw)
    for i, (a, b) in enumerate(zip(got[1:], again[1:])):
        assert torch.equal(a, b), i
    fixed = {1, 2, 6, 7, 10}  # fluence, exitance, TPSF, path sums, jac
    for i in fixed:
        assert got[i].dtype == torch.int64
    # the Jacobian's deposits, rounded one by one, summed cell by cell
    # from the last segment to the first
    deposits, st = [], state
    for _ in range(args[6]):
        res = ph.step(st, vol.labels.reshape(-1), vol.media, SHAPE, 0.5, cfg)
        deposits.append((res.dep_idx * 3 + kw["jac_col"].long(),
                         to_fixed(kw["jac_w"] * res.seg_len,
                                  spec.FIXED_SHIFT["jac"])))
        st = res.state
    want = torch.zeros_like(got[10])
    for idx, units in reversed(deposits):
        for j in reversed(range(idx.numel())):
            want[idx[j]] += units[j]
    assert torch.equal(got[10], want) and int(want.sum()) > 0
    # with totals, the call adds into them and returns them
    totals = [torch.full_like(got[i], 5) for i in sorted(fixed)]
    into = photon_steps_ref(*args, **kw, totals=totals)
    for t, i in zip(totals, sorted(fixed)):
        assert into[i] is t and torch.equal(t, got[i] + 5)


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


def test_sass_names_the_kernels_by_their_template_flags():
    """The step kernel and its appending twin (the RECORD libraries'
    launch given the round's records) are named by their template flags;
    a device function that is no kernel has none."""
    ns = "_ZN12_GLOBAL__N_1"
    assert sass.template_flags(
        ns + "18photon_step_kernelILb1ELb0EEEvNS_4ArgsE") == (True, False)
    assert sass.template_flags(
        ns + "25photon_step_append_kernelILb0ELb1EEEvNS_4ArgsE") == (
        False, True)
    assert sass.template_flags(ns + "14append_recordsERKNS_4ArgsEPy") == ()


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

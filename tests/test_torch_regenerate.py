"""The regeneration kernel's wrapper and the round loop's choice of
path, on the CPU.

The kernel (``kernels/photon_step/csrc/regenerate.cu``) runs only on the
card; ``tests/test_torch_cuda.py`` holds it bit-equal to the plain
``simulator._regenerate`` there.  Here: the entry point's comment and
the wrapper's argument order agree, the kernel's source table matches
what each source type stages, the three places that build the round
loop's sampler hand it the source class and its staged tensors, a CPU
run takes the plain path and counts no kernel call, and the wrapper
refuses CPU tensors.
"""

import dataclasses
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenarios as SC  # noqa: E402
from repro_torch import sources as SR  # noqa: E402
from repro_torch.core import photon as ph  # noqa: E402
from repro_torch.core import procs  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as K  # noqa: E402
from repro_torch.kernels.photon_step import regenerate as RG  # noqa: E402
from repro_torch.sources.base import (StagedSampler,  # noqa: E402
                                      staged_tensors)

SHAPE = (12, 12, 12)
DISK = SR.Disk(pos=(6.0, 6.0, 0.0), radius=2.0)


def _entry_point_lists() -> dict[str, list[str]]:
    """The names the C entry point's comment lists for ``ptrs`` and
    ``ints``, with a ``(5)`` count kept beside its name."""
    text = K.REGEN_SRC.read_text()
    doc = text[text.index("// Plain C entry point"):
               text.index('extern "C" int regenerate_launch')]
    doc = " ".join(ln.strip().lstrip("/").strip() for ln in doc.splitlines())
    out = {}
    for key, nxt in (("ptrs:", ";"), ("ints:", "The lane arrays")):
        part = doc[doc.index(key) + len(key):]
        out[key[:-1]] = re.findall(r"[a-z_0-9]+(?: \(\d+\))?",
                                   part[:part.index(nxt)])
    return out


def test_wrapper_packs_what_the_entry_point_documents():
    doc = _entry_point_lists()
    assert doc["ptrs"] == list(RG.PTRS[:-1]) + [f"params ({RG.PARAMS})"]
    assert doc["ints"] == list(RG.INTS)
    # the state leads, in PhotonState's order (the wrapper fills it so)
    assert RG.PTRS[:len(ph.PhotonState._fields)] == ph.PhotonState._fields
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             K.REGEN_SRC.read_text()))
    assert int(consts["kThreads"]) == RG.THREADS
    assert int(consts["kParams"]) == RG.PARAMS
    assert int(consts["kTotalShift"]) == S.spec.TOTAL_SHIFT


def test_kernel_source_table_matches_what_each_type_stages():
    """Every registered type has a row; each demo source stages exactly
    the row's keys (the optional one where the source has it), scalars
    as scalars and vectors of 3."""
    assert {c.type_name for c in RG.SOURCES} == set(SR.available_sources())
    kinds = sorted(k for k, _ in RG.SOURCES.values())
    assert kinds == list(range(len(RG.SOURCES)))
    for name, src in SR.demo_menu(24).items():
        cls = type(src)
        _, keys = RG.SOURCES[cls]
        staged = src.stage()
        opt = RG.OPTIONAL.get(cls)
        want = [k for k in keys if k != opt or k in staged]
        assert sorted(staged) == sorted(want), name
        assert len(want) <= RG.PARAMS
        for k in want:
            shape = np.shape(staged[k])
            if k == "pattern":
                assert len(shape) == 2, name
            else:
                assert shape == (() if k in RG._SCALARS else (3,)), (name, k)


def test_supports_staged_samplers_of_the_seven_types_on_cuda_only():
    staged = staged_tensors(DISK.stage(), "cpu")
    sampler = StagedSampler(SR.Disk, staged)
    assert RG.supports(sampler, "cuda")
    assert RG.supports(sampler, torch.device("cuda", 0))
    assert not RG.supports(sampler, "cpu")

    class Other(SR.Disk):
        pass

    assert not RG.supports(StagedSampler(Other, staged), "cuda")
    assert not RG.supports(lambda ids, seeds: sampler(ids, seeds), "cuda")
    assert RG.source_key(SR.Pencil, 1) == "regenerate/pencil"
    assert RG.source_key(SR.Disk, 8) == "regenerate/disk/x8"


class _Captured(Exception):
    pass


@pytest.mark.parametrize("caller", ["source_sampler", "simulate_many",
                                     "procs"])
def test_each_sampler_maker_hands_the_loop_the_source_and_staged_tensors(
        caller, monkeypatch):
    """``simulator.source_sampler`` (``simulate`` and its kin),
    ``scenarios._raw_batched_fn`` (``simulate_many``) and ``procs``'s
    batched work build the round loop with a ``StagedSampler``, so the
    loop can hand the kernel the source class and its staged tensors;
    the sampler gives what ``sample_staged`` gives."""
    seen = []

    def fake_loop(shape, unitinmm, cfg, n_lanes, mode="dynamic",
                  sample=None, device=None, *args, **kw):
        seen.append((sample, torch.device(device)))

        def fn(*a, **k):
            raise _Captured
        return fn

    monkeypatch.setattr(S, "build_round_loop", fake_loop)
    vol = V.benchmark_b2(SHAPE)
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=4)
    other = SR.Disk(pos=(5.0, 6.0, 0.0), radius=2.0)
    with pytest.raises(_Captured):
        if caller == "source_sampler":
            S.simulate_fixed(vol, cfg, 100, 64, 3, source=DISK,
                             device="cpu")
        elif caller == "simulate_many":
            SC.simulate_many([SC.Scenario(vol, cfg, 100, source=s)
                              for s in (DISK, other)], n_lanes=64,
                             device="cpu", cache=SC.CompileCache())
        else:
            staged = {k: np.stack([np.asarray(s.stage()[k], np.float32)
                                   for s in (DISK, other)])
                      for k in DISK.stage()}
            work = procs.batched_work(SHAPE, 1.0, cfg, 64, "dynamic",
                                      SR.Disk, 0)
            procs._op_batched(
                types.SimpleNamespace(device=torch.device("cpu")), {}, work,
                (vol.labels.reshape(-1), vol.media[None].repeat(2, 1, 1),
                 staged, None, [100, 100], [3, 3], [0, 100], [0, 0]), None)
    ((sample, dev),) = seen
    assert isinstance(sample, StagedSampler)
    assert sample.source_cls is SR.Disk
    S_n = 1 if caller == "source_sampler" else 2
    assert sorted(sample.staged) == sorted(DISK.stage())
    for k, x in sample.staged.items():
        assert x.dtype == torch.float32 and x.device == dev
        assert x.shape[0] == S_n, k
        assert torch.equal(x[0].cpu(), torch.as_tensor(
            np.asarray(DISK.stage()[k], np.float32)))
    ids = S.xrng.add_id(torch.zeros((S_n, 1), dtype=torch.int64),
                        torch.zeros((S_n, 1), dtype=torch.int64),
                        torch.arange(5))
    seeds = torch.full((S_n, 1), 3, dtype=torch.int64)
    for x, y in zip(sample(ids, seeds),
                    SR.Disk.sample_staged(sample.staged, ids, seeds)):
        assert torch.equal(x, y)
    assert RG.supports(sample, "cuda") and not RG.supports(sample, dev)


def test_cpu_run_takes_the_plain_path_and_counts_no_kernel_call(
        monkeypatch):
    """On the CPU the loop never binds the kernel: the run is the plain
    ``_regenerate``'s, bit for bit, and no ``regenerate/*`` launch is
    counted."""
    vol = V.benchmark_b1(SHAPE)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=8)
    args = (vol, cfg, 400, 64, 5)
    kw = dict(source=DISK, device="cpu")
    K.reset_launches()
    before = S.simulate_fixed(*args, **kw)
    assert not any(k.startswith("regenerate/")
                   for k in K.photon_step_cuda.launches_by)

    def refuse(*a, **k):
        raise AssertionError("a CPU run bound the regeneration kernel")

    calls = []

    def plain(*a, **k):
        calls.append(1)
        return regenerate(*a, **k)

    regenerate = S._regenerate
    monkeypatch.setattr(S, "Regeneration", refuse)
    monkeypatch.setattr(S, "_regenerate", plain)
    again = S.simulate_fixed(*args, **kw)
    # once a round issued: the rounds with work, then no-op rounds up to
    # the next host read
    reads = -(-(again.steps // 8) // S.ROUNDS_PER_READ)
    assert len(calls) == reads * S.ROUNDS_PER_READ
    for name, x, y in zip(S.FixedResult._fields, before, again):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def test_wrapper_raises_on_cpu_tensors():
    n_sc, n = 2, 64
    i64 = dict(dtype=torch.int64)
    sampler = StagedSampler(SR.Disk, {
        k: v.repeat((n_sc,) + (1,) * (v.ndim - 1))
        for k, v in staged_tensors(DISK.stage(), "cpu").items()})
    with pytest.raises(ValueError, match="CUDA tensors"):
        RG.Regeneration(sampler, "dynamic", SHAPE,
                        torch.zeros(n_sc, **i64), torch.zeros(n_sc, n, **i64),
                        torch.ones(n_sc, n, **i64), torch.zeros(n_sc, **i64),
                        torch.zeros(n_sc, 1, **i64))

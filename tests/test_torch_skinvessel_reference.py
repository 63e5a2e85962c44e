"""The port on a skin-vessel-shaped volume against repro.core.simulator.

The port's labels and media of a 24^3 grid with the skin-vessel's
structure (``tests/test_torch_skinvessel.py``: water over epidermis over
dermis, a vessel along x, five media rows, 5 um voxels) are handed to
``repro.core.volume.Volume``, and both packages run the same disk beam
to 50 ns without reflection.  As in ``tests/test_torch_simulator.py``,
photon accounting is exact (the same ids and RNG words) and the
absorbed, escaped and timed-out weight agree within 2e-3 of the
launched weight (float32 in the port, FMA-contracted in XLA's CPU code:
trajectories that diverge are independent draws).  Over seeds 1-4 here
the largest difference measured was 2.5e-7 of the launched weight at
1500 photons and 9.5e-7 at 6000: the paths in this small grid are short.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analysis as JA  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402

SHAPES = [{"Grid": {"Tag": 1, "Size": [24, 24, 24]}},
          {"ZLayers": [[1, 3, 1], [4, 5, 4], [6, 24, 3]]},
          {"Cylinder": {"Tag": 2, "C0": [0, 12.5, 12.5],
                        "C1": [24, 12.5, 12.5], "R": 3}}]
SOURCE = {"type": "disk", "pos": [12.0, 12.0, 3.0], "dir": [0.0, 0.0, 1.0],
          "radius": 6.0}
TOTALS_TOL = 2e-3
PHOTONS = 1500


@pytest.mark.parametrize("seed", [1, 2])
def test_skinvessel_shaped_volume_matches_reference(seed):
    tv = TV.volume_from_shapes(SHAPES, list(TV.SKINVESSEL_MEDIA),
                               TV.SKINVESSEL_UNITINMM)
    jv = JV.Volume(labels=jnp.asarray(tv.labels.numpy()),
                   media=jnp.asarray(tv.media.numpy()),
                   unitinmm=tv.unitinmm)
    cfg = dataclasses.replace(TV.skinvessel_config(), steps_per_round=8)
    jcfg = JV.SimConfig(**dataclasses.asdict(cfg))
    ref = JS.simulate(jv, jcfg, PHOTONS, 1024, seed, source=SOURCE)
    jax.block_until_ready(ref)
    got = TS.simulate(tv, cfg, PHOTONS, 1024, seed, source=SOURCE,
                      device="cpu")
    assert int(got.n_launched) == int(ref.n_launched) == PHOTONS
    assert float(got.launched_w) == float(ref.launched_w)
    assert got.energy.shape == (24, 24, 24)
    jb, tb = JA.energy_balance(ref), TA.energy_balance(got)
    for key in ("absorbed", "escaped", "timed_out"):
        assert abs(tb[key] - jb[key]) <= TOTALS_TOL * jb["launched"], key
    assert abs(tb["residue_frac"]) < 1e-5

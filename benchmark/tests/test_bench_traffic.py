"""The seeded generator: the same seed gives the same winds bit for bit,
another seed others, within the traffic's ranges; the host and device
forms agree."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import winds as W
ROOT = Path(__file__).resolve().parents[2]

SPEC = json.loads((ROOT / "benchmark" / "traffic"
                   / "resident-ring4.json").read_text())["winds"]
LATS = np.linspace(90.0, -90.0, 37)
LONS = np.linspace(-180.0, 175.0, 72)
SEED = 2 ** 31 + 977


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_repeats_per_seed(dtype):
    a = W.stack_numpy(W.draw(SPEC, SEED, 0), LATS, LONS, 5, dtype)
    b = W.stack_numpy(W.draw(SPEC, SEED, 0), LATS, LONS, 5, dtype)
    for x, y in zip(a, b):
        assert x.dtype == dtype and x.shape == (5, 37, 72)
        assert x.tobytes() == y.tobytes()


def test_repeats_on_torch():
    p = W.draw(SPEC, SEED, 1, 2)
    a = W.stack_torch(p, LATS, LONS, 5, torch.float32, "cpu")
    b = W.stack_torch(p, LATS, LONS, 5, torch.float32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h = W.stack_numpy(p, LATS, LONS, 5, np.float64)
    for x, y in zip(a, h):
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("other", [(SEED + 1, 0), (SEED, 1), (7, 0)])
def test_differs_across_seeds_and_slots(other):
    a = W.stack_numpy(W.draw(SPEC, SEED, 0, 2), LATS, LONS, 3, np.float64)
    b = W.stack_numpy(W.draw(SPEC, *other, 2), LATS, LONS, 3, np.float64)
    assert not np.array_equal(a[0], b[0])


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 11, 2 ** 40 + 3])
def test_ranges(seed):
    p = W.draw(SPEC, seed, 0)
    assert SPEC["jet_ms"][0] <= p["jet"] <= SPEC["jet_ms"][1]
    for w in p["waves"]:
        assert SPEC["wave_ms"][0] <= w["amp"] <= SPEC["wave_ms"][1]
        assert SPEC["wavenumbers"][0] <= w["m"] <= SPEC["wavenumbers"][1]
    u, v = W.stack_numpy(p, LATS, LONS, 3, np.float64)
    # every component bounded by its terms' amplitudes
    cap = p["jet"] * 1.05 + sum(w["amp"] for w in p["waves"]) \
        + sum(m["amp"] for m in p["modes"]["u"])
    assert np.abs(u).max() <= cap + 1e-9 and np.isfinite(v).all()


def test_every_seed_draws_the_same_speeds():
    """The seed orders a fixed set of speeds and wavenumbers: it changes
    the arrangement of the work, not its size."""
    def sizes(seed):
        ps = [W.draw(SPEC, seed, k, 4) for k in range(4)]
        return (sorted(p["jet"] for p in ps),
                sorted(w["amp"] for p in ps for w in p["waves"]),
                sorted(w["m"] for p in ps for w in p["waves"]),
                sorted(m["amp"] for p in ps for m in p["modes"]["u"]))
    assert sizes(SEED) == sizes(SEED + 1) == sizes(3)
    assert sizes(SEED)[0] == [22.5, 27.5, 32.5, 37.5]

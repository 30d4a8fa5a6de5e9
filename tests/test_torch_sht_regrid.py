"""Port parity of the ``isglobal`` preprocessing: ``ops/regrid.py``,
``ops/sht.py`` and the completed ``ops/stencil.py`` against the JAX package,
on the CPU in float64.

Bounds:
* regrid within 1e-12 (the same four taps in JAX's expression order);
* SHT truncation within 1e-11 of the field's largest value, on the common
  grid's latitudes and its odd nx = 721; the operators are the same numpy
  code and must be equal to JAX's;
* the spectral contract of tests/test_sht.py (retained modes pass, the rest
  vanish) at that file's bounds;
* stencils: bit-identical to JAX's (the same operations in float32, Q6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lagrangiancoherence_tpu.api import COMMON_GRID_LATS as JAX_LATS
from lagrangiancoherence_tpu.api import COMMON_GRID_LONS as JAX_LONS
from lagrangiancoherence_tpu.ops import regrid as JR
from lagrangiancoherence_tpu.ops import sht as JS
from lagrangiancoherence_tpu.ops import stencil as JST
from lagrangiancoherence_tpu_torch.api import (COMMON_GRID_LATS,
                                               COMMON_GRID_LONS)
from lagrangiancoherence_tpu_torch.ops import regrid as TR
from lagrangiancoherence_tpu_torch.ops import sht as TS
from lagrangiancoherence_tpu_torch.ops import stencil as TST

torch.set_num_threads(1)

REGRID_ATOL = 1e-12
SHT_RTOL = 1e-11          # of max |field|
T = 20


@pytest.fixture(scope="module", autouse=True)
def _float64():
    """Host arrays take torch's default dtype (JAX's x64 switch, on in
    tests/conftest.py)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def common_field(nt=2, seed=0):
    """Seeded random winds on the common 0.5-degree grid (360 x 721)."""
    rng = np.random.RandomState(seed)
    return rng.randn(nt, COMMON_GRID_LATS.size, COMMON_GRID_LONS.size)


def real_ynm(n, m, lats, lons):
    """Independent Y_n^m oracle via scipy (tests/test_sht.py:54-58)."""
    from scipy.special import sph_harm_y
    LON, CLAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(90.0 - lats))
    return np.real(sph_harm_y(n, m, CLAT, LON))


def truncate64(f, lats=COMMON_GRID_LATS, truncation=T):
    return TS.truncate(torch.tensor(f), lats, truncation).numpy()


def test_common_grid_matches_jax():
    np.testing.assert_array_equal(COMMON_GRID_LATS, JAX_LATS)
    np.testing.assert_array_equal(COMMON_GRID_LONS, JAX_LONS)
    assert COMMON_GRID_LONS.size % 2 == 1


@pytest.mark.parametrize("truncation", [10, 20])
def test_operators_equal_jax(truncation):
    got = TS.truncation_operators(COMMON_GRID_LATS, truncation)
    want = JS.truncation_operators(JAX_LATS, truncation)
    assert got.shape == (truncation + 1, 360, 360)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nx", [721, 720])
def test_truncate_matches_jax(nx):
    f = common_field()[..., :nx]
    want = np.asarray(JS.truncate(jnp.asarray(f), JAX_LATS, T))
    got = truncate64(f)
    assert got.shape == f.shape and got.dtype == np.float64
    assert np.abs(got - want).max() <= SHT_RTOL * np.abs(f).max()


def test_truncate_host_array_takes_default_dtype():
    f = common_field(nt=1)
    got = TS.truncate(f, COMMON_GRID_LATS, T, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), truncate64(f))
    torch.set_default_dtype(torch.float32)
    try:
        assert TS.truncate(f, COMMON_GRID_LATS, T,
                           device="cpu").dtype == torch.float32
    finally:
        torch.set_default_dtype(torch.float64)


def periodic_lons(nx):
    """An exactly periodic longitude axis of nx points (odd or even)."""
    return -180.0 + 360.0 * np.arange(nx) / nx


@pytest.mark.parametrize("nx", [721, 720])
class TestSpectralContract:
    """tests/test_sht.py's contract on the common latitudes with an exactly
    periodic longitude axis, odd (721, as the common grid) and even:
    reproduce every Y_n^m with n <= T, annihilate n > T or m > T."""

    @pytest.mark.parametrize("n,m", [(0, 0), (3, 2), (10, 7), (20, 5),
                                     (20, 20)])
    def test_retained_modes_pass_through(self, nx, n, m):
        f = real_ynm(n, m, COMMON_GRID_LATS, periodic_lons(nx))
        out = truncate64(f)
        assert np.abs(out - f).max() / np.abs(f).max() < 1e-10

    @pytest.mark.parametrize("n,m", [(21, 0), (21, 20), (25, 10), (40, 0),
                                     (25, 23)])
    def test_high_modes_annihilated(self, nx, n, m):
        f = real_ynm(n, m, COMMON_GRID_LATS, periodic_lons(nx))
        out = truncate64(f)
        assert np.abs(out).max() / np.abs(f).max() < 1e-10

    def test_mixed_field_splits_exactly(self, nx):
        lats, lons = COMMON_GRID_LATS, periodic_lons(nx)
        f_low = real_ynm(4, 1, lats, lons) + 0.3 * real_ynm(15, 12, lats, lons)
        f_high = (0.7 * real_ynm(22, 3, lats, lons)
                  + 0.5 * real_ynm(30, 25, lats, lons))
        out = truncate64(f_low + f_high)
        assert np.abs(out - f_low).max() / np.abs(f_low).max() < 1e-10

    def test_idempotent_and_batched(self, nx):
        f = common_field(nt=3)[..., :nx]
        once = truncate64(f)
        np.testing.assert_allclose(truncate64(once), once, atol=1e-8)
        np.testing.assert_array_equal(truncate64(f[1]), once[1])

    def test_zonal_legendre_above_T_removed(self, nx):
        from numpy.polynomial.legendre import Legendre
        x = np.sin(np.deg2rad(COMMON_GRID_LATS))
        coeffs = np.zeros(31)
        coeffs[30] = 1.0
        f = np.broadcast_to(Legendre(coeffs)(x)[:, None],
                            (x.size, nx)).copy()
        assert np.abs(truncate64(f)).max() < 1e-12 * np.abs(f).max()


def test_truncate_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TS.truncate(common_field(nt=1), COMMON_GRID_LATS, T, device="cuda")


# ---------------------------------------------------------------------------
# regrid
# ---------------------------------------------------------------------------

REGRID_CASES = {
    # the isglobal path: a 2-degree global grid onto the common grid
    "to_common": (np.arange(-88.0, 89.0, 2.0), np.arange(-180.0, 180.0, 2.0),
                  COMMON_GRID_LATS, COMMON_GRID_LONS),
    # the flagship's 0.25-degree rows, cut to a band, onto the common grid
    # (targets outside the band take the nearest fallback)
    "quarter_band": (np.linspace(-30.0, 30.0, 241),
                     np.linspace(-180.0, 179.75, 1440),
                     COMMON_GRID_LATS, COMMON_GRID_LONS),
    # irregular source spacing and exact-node / midpoint targets
    "irregular": (np.cumsum(np.random.RandomState(3).uniform(0.5, 2.0, 30))
                  - 20.0,
                  np.cumsum(np.random.RandomState(4).uniform(0.5, 2.0, 40))
                  - 30.0,
                  np.linspace(-25.0, 40.0, 53), np.linspace(-35.0, 50.0, 61)),
}


@pytest.mark.parametrize("case", sorted(REGRID_CASES))
def test_regrid_matches_jax(case):
    src_lats, src_lons, dst_lats, dst_lons = REGRID_CASES[case]
    rng = np.random.RandomState(5)
    f = rng.randn(2, src_lats.size, src_lons.size)
    want = np.asarray(JR.regrid_linear_nearest(jnp.asarray(f), src_lats,
                                               src_lons, dst_lats, dst_lons))
    got = TR.regrid_linear_nearest(torch.tensor(f), src_lats, src_lons,
                                   dst_lats, dst_lons).numpy()
    assert got.shape == (2, dst_lats.size, dst_lons.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=REGRID_ATOL)


def test_regrid_nearest_ties_and_nodes():
    src = np.array([0.0, 1.0, 2.0, 3.0])
    dst = np.array([-1.0, 0.0, 0.5, 1.0, 2.5, 3.0, 4.0])
    f = np.arange(16.0).reshape(4, 4)
    want = np.asarray(JR.regrid_linear_nearest(jnp.asarray(f), src, src,
                                               dst, dst))
    got = TR.regrid_linear_nearest(torch.tensor(f), src, src, dst,
                                   dst).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# stencils: isglobal=False and out_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("isglobal", [True, False])
@pytest.mark.parametrize("dim", [0, 1])
def test_stencil_matches_jax(dim, isglobal):
    rng = np.random.RandomState(6)
    a = rng.randn(9, 12).astype(np.float32)
    want = np.asarray(JST.fourth_order_derivative(jnp.asarray(a), dim=dim,
                                                  isglobal=isglobal))
    got = TST.fourth_order_derivative(torch.tensor(a), dim=dim,
                                      isglobal=isglobal).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dtype", [None, "float32", "float64"])
@pytest.mark.parametrize("isglobal", [True, False])
@pytest.mark.parametrize("dim", [0, 1])
def test_spherical_derivative_matches_jax(dim, isglobal, out_dtype):
    rng = np.random.RandomState(7)
    lats, lons = np.linspace(-40, 40, 17), np.linspace(-60, 30, 19)
    v = rng.randn(17, 19) * 1e6
    want = np.asarray(JST.derivative_spherical_coords(
        jnp.asarray(v), lats, lons, dim=dim, isglobal=isglobal,
        out_dtype=None if out_dtype is None else getattr(jnp, out_dtype)))
    got = TST.derivative_spherical_coords(
        torch.tensor(v), lats, lons, dim=dim, isglobal=isglobal,
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype))
    assert got.numpy().dtype == want.dtype
    # with out_dtype=float32 the metric's cos runs in float32, where XLA's
    # and torch's cos may differ by an ulp (6e-8)
    rtol = 2e-7 if out_dtype == "float32" else 1e-15
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)

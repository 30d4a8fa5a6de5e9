"""Port parity of the CLI: ``python -m lagrangiancoherence_tpu_torch.cli``
against ``lagrangiancoherence_tpu.cli`` on the same small input file, on the
CPU (``--device cpu``), in float64.

The JAX CLI runs once, under ``jax.disable_jit()``: under ``jit`` XLA fuses
the float32 stencil stage of the FTLE (quirk Q6) and moves it by ~1e-7 of
the field (tests/test_torch_api.py), while JAX's eager evaluation and the
port agree to round-off.  Bounds: FTLE within 1e-9 of the field's largest
value, departure points within 1e-10 degrees, the same dims and coords.
"""
import os

import numpy as np
import pytest
import torch

import jax
from lagrangiancoherence_tpu import cli as JC
from lagrangiancoherence_tpu.field import Field as JField
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import cli as TC

h5py = pytest.importorskip("h5py")

from lagrangiancoherence_tpu.utils.io import open_dataset  # noqa: E402
from lagrangiancoherence_tpu.utils.io import save_dataset  # noqa: E402

torch.set_num_threads(1)

FTLE_RTOL = 1e-9
POSITION_ATOL = 1e-10
ARGS = ["--timestep", "-21600", "--settls-order", "2", "--quiet"]


@pytest.fixture(scope="module", autouse=True)
def _float64():
    """The port's SETTLS dtype follows torch's default dtype (JAX's x64
    switch, on in tests/conftest.py)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def write_winds(path, nt=4):
    """tests/test_cli_examples.py:17-24 (the ideal saddle)."""
    u, v, lats, lons, times = flows.ideal_saddle(
        **dict(flows.SADDLE_CONFIG, nt=nt))
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    save_dataset({"u": JField(u, dims, coords, name="u"),
                  "v": JField(v, dims, coords, name="v")}, str(path))
    return lats, lons


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI with --return-traj: the FTLE and both departure files."""
    d = tmp_path_factory.mktemp("jax_cli")
    write_winds(d / "winds.nc")
    with jax.disable_jit():
        assert JC.main([str(d / "winds.nc"), str(d / "traj.nc"), *ARGS,
                        "--return-traj"]) == 0
    return d


def port_cli(args):
    return TC.main([*args, "--device", "cpu"])


def assert_same_file(got_path, want_path, var, rtol=None, atol=None):
    got, want = open_dataset(str(got_path)), open_dataset(str(want_path))
    assert set(got) == set(want) == {var}
    g, w = got[var], want[var]
    assert g.dims == w.dims and g.shape == w.shape
    assert set(g.coords) == set(w.coords)
    for k in w.coords:
        np.testing.assert_array_equal(g.coords[k], w.coords[k])
    assert np.array_equal(np.isnan(g.data), np.isnan(w.data))
    if rtol is not None:
        scale = np.nanmax(np.abs(w.data))
        assert np.nanmax(np.abs(g.data - w.data)) <= rtol * scale
    else:
        np.testing.assert_allclose(g.data, w.data, rtol=0, atol=atol)


def test_ftle_file_matches_jax_cli(jax_run, tmp_path):
    inp, out = jax_run / "winds.nc", tmp_path / "ftle.nc"
    assert port_cli([str(inp), str(out), *ARGS]) == 0
    assert_same_file(out, jax_run / "traj.nc", "ftle", rtol=FTLE_RTOL)
    assert open_dataset(str(out))["ftle"].shape == (1, 60, 60)
    assert os.path.exists(inp), "input must NEVER be deleted (Q8 fix)"


def test_return_traj_files_match_jax_cli(jax_run, tmp_path):
    out = tmp_path / "traj.nc"
    assert port_cli([str(jax_run / "winds.nc"), str(out), *ARGS,
                     "--return-traj"]) == 0
    assert_same_file(out, jax_run / "traj.nc", "ftle", rtol=FTLE_RTOL)
    for var in ("x_departure", "y_departure"):
        assert_same_file(tmp_path / f"traj_{var}.nc",
                         jax_run / f"traj_{var}.nc", var, atol=POSITION_ATOL)


def test_idempotent_skip(jax_run, tmp_path):
    out = tmp_path / "ftle.nc"
    args = [str(jax_run / "winds.nc"), str(out), "--settls-order", "0",
            "--quiet"]
    assert port_cli(args) == 0
    mtime = os.path.getmtime(out)
    assert port_cli(args) == 0
    assert os.path.getmtime(out) == mtime, "existing output rewritten"
    assert port_cli(args + ["--overwrite"]) == 0


@pytest.mark.parametrize("order", [0, 1, 2, 5])
def test_full_scipy_order_surface(jax_run, tmp_path, order):
    """Every scipy spline order; the CPU takes the plain gather for all."""
    out = tmp_path / f"ftle_o{order}.nc"
    assert port_cli([str(jax_run / "winds.nc"), str(out), "--settls-order",
                     "1", "--interp-order", str(order), "--quiet"]) == 0
    ftle = open_dataset(str(out))["ftle"]
    assert ftle.shape == (1, 60, 60) and np.isfinite(ftle.data).all()


def test_subdomain_and_isglobal(jax_run, tmp_path):
    sub, glob = tmp_path / "sub.nc", tmp_path / "glob.nc"
    inp = str(jax_run / "winds.nc")
    assert port_cli([inp, str(sub), *ARGS,
                     "--subdomain=-60/-20/-50/-30"]) == 0
    f = open_dataset(str(sub))["ftle"]
    assert f.coords["latitude"].min() > -50 and f.coords["latitude"].max() < -30
    assert port_cli([inp, str(glob), "--settls-order", "1", "--isglobal",
                     "--truncation", "10", "--quiet"]) == 0
    assert open_dataset(str(glob))["ftle"].shape == (1, 360, 721)


def test_parser_matches_jax():
    for spec in ("-90/-32/-40/15", None):
        assert TC.parse_subdomain(spec) == JC.parse_subdomain(spec)
    jax_opts = {a.dest: a.default for a in JC.build_parser()._actions}
    port_opts = {a.dest: a.default for a in TC.build_parser()._actions}
    assert port_opts.pop("device") == "cuda"
    assert port_opts == jax_opts


def test_default_device_needs_a_card(jax_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TC.main([str(jax_run / "winds.nc"), str(tmp_path / "o.nc"),
                 "--quiet"])
    assert not (tmp_path / "o.nc").exists()

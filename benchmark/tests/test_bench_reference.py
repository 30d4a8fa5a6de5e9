"""The plain reference against the program on the CPU in float64, where
both state the same semantics and only rounding separates them: a second
witness that the reference is right."""
import numpy as np
import torch

from benchmark import winds as W
from benchmark.reference import facade as RF
from benchmark.reference import ftle as R
from _small import SEED, small


def _winds(c, nt, dtype=np.float64):
    g = c["config"]["grid"]
    lats = np.linspace(-90.0, 90.0, g["ny"])
    lons = np.linspace(g["lon_first"], g["lon_last"], g["nx"])
    u, v = W.stack_numpy(W.draw(c["traffic"]["winds"], SEED, 0), lats, lons,
                         nt, dtype)
    return lats, lons, u, v


def test_ftle_matches_the_program_in_float64():
    from lagrangiancoherence_tpu_torch.grid import Grid
    from lagrangiancoherence_tpu_torch.models.pipeline import ftle_pipeline
    c = small("global-resident", ny=61, nx=120, levels=9)
    lats, lons, u, v = _winds(c, 9)
    prog = ftle_pipeline(torch.tensor(u), torch.tensor(v), -21600.0,
                         Grid(lats=lats, lons=lons, cyclic_x=True),
                         settls_order=4, interp_order=3, kernel="torch",
                         device="cpu").numpy()
    ref = R.ftle(torch.tensor(u), torch.tensor(v), lats, lons, -21600.0,
                 settls_order=4, order=3).numpy()
    assert np.array_equal(np.isnan(prog), np.isnan(ref))
    np.testing.assert_allclose(prog, ref, rtol=1e-9, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0000002], dtype=torch.float32)
    y = R.round_tf32(x)
    assert y[0] == 1.0 and y[1] in (1.0, 1.0 + 2 ** -10)
    assert y[2] == 1.0 + 2 ** -10 and y[3] == -3.0
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)


def test_facade_matches_the_program_in_float64():
    from lagrangiancoherence_tpu_torch.api import LCS
    from lagrangiancoherence_tpu_torch.field import Field
    c = small("cli-t20")
    g = c["config"]["grid"]
    lats = np.linspace(90.0, -90.0, g["ny"])
    lons = np.linspace(g["lon_first"], g["lon_last"], g["nx"])
    u, v = W.stack_numpy(W.draw(c["traffic"]["winds"], SEED, 0), lats, lons,
                         3, np.float64)
    t = np.datetime64("2021-01-01T00") + np.arange(3) * np.timedelta64(6, "h")
    f = [Field(a, ("time", "latitude", "longitude"),
               {"time": t, "latitude": lats, "longitude": lons}, name=n)
         for a, n in ((u, "u"), (v, "v"))]
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        prog = LCS(timestep=-21600.0, SETTLS_order=4, device="cpu")(
            u=f[0], v=f[1], isglobal=True, truncation=20,
            verbose=False).data[0]
    finally:
        torch.set_default_dtype(old)
    ref = RF.lcs_ftle(u, v, lats, lons, -21600.0, settls_order=4,
                      truncation=20, device="cpu")
    assert np.array_equal(np.isnan(prog), np.isnan(ref))
    np.testing.assert_allclose(prog, ref, rtol=1e-7, atol=1e-9)


def test_resample_matches_the_program():
    """The reference's linear resample to whole hours against the facade's
    (labels from the start of the first record's day)."""
    from lagrangiancoherence_tpu_torch.api import _resample_linear
    from lagrangiancoherence_tpu_torch.field import Field
    rng = np.random.default_rng(5)
    a = rng.standard_normal((9, 3, 4))
    t = np.datetime64("2021-01-01T03") + np.arange(9) * np.timedelta64(6, "h")
    f = Field(a, ("time", "latitude", "longitude"),
              {"time": t, "latitude": np.arange(3.0),
               "longitude": np.arange(4.0)}, name="u")
    prog = _resample_linear(f, "12h", "time")
    ref, labels = RF.resample_linear(a, t, "12h")
    assert np.array_equal(labels.astype("M8[s]"),
                          prog.coords["time"].astype("M8[s]"))
    np.testing.assert_allclose(ref, prog.data, rtol=1e-12, atol=1e-12)
    assert np.isnan(ref[0]).all()        # 00h lies before the first record

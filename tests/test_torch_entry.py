"""The port's entry points (``lagrangiancoherence_tpu_torch/
entry.py``) on the CPU: ``entry(device="cpu")`` gives JAX's
``__graft_entry__.entry()`` field within 1e-4 of its largest value (both in
float32: the packages' last bits differ and the SETTLS-4 vortex grows
them), and ``dryrun_multichip(4, device="cpu")`` passes its own 1e-4 legs
(JAX's), the windowed route's included."""
import numpy as np
import torch

import __graft_entry__ as jax_entry
from lagrangiancoherence_tpu_torch.entry import dryrun_multichip, entry
from lagrangiancoherence_tpu_torch.ops import cuda_settls, cuda_window

torch.set_num_threads(1)

ENTRY_RTOL = 1e-4


def test_entry_matches_jax():
    fn, (u, v) = entry(device="cpu")
    assert u.device.type == "cpu" and u.dtype == torch.float32
    assert u.shape == v.shape == (9, 181, 360)
    before = cuda_settls.LAUNCHES
    got = fn(u, v).numpy()
    assert cuda_settls.LAUNCHES == before
    jfn, jargs = jax_entry.entry()
    np.testing.assert_array_equal(u.numpy(), np.asarray(jargs[0]))
    want = np.asarray(jfn(*jargs))
    assert got.shape == want.shape == (181, 360)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[2:-2]).all()
    assert np.nanmax(np.abs(got - want)) <= \
        ENTRY_RTOL * np.nanmax(np.abs(want))


def test_dryrun_multichip(capsys):
    before = dict(cuda_window.LAUNCHES)
    legs = dryrun_multichip(4, device="cpu")
    assert cuda_window.LAUNCHES == before
    for k in ("sigma", "mesh_2d", "windowed"):
        assert legs[k] < 1e-4, legs
    assert legs["windowed_2d"].startswith("SKIPPED")
    assert "dryrun_multichip(4): ok" in capsys.readouterr().out

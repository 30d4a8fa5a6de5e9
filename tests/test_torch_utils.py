"""The port's profiling and debug utilities (utils/profiling.py,
utils/debug.py) on the CPU: counterparts of the JAX package's, which no test
of its own covers."""
import json
import time

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import Grid, ftle_pipeline
from lagrangiancoherence_tpu_torch.utils.debug import checked_ftle, nan_debug
from lagrangiancoherence_tpu_torch.utils.profiling import (
    StageTimer, device_memory_stats, trace)

torch.set_num_threads(1)


def _vortex():
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    cfg.update(dx=4, dy=4, nt=3)
    u, v, lats, lons, _ = flows.ideal_vortex(**cfg)
    return u, v, Grid(lats=lats, lons=lons, cyclic_x=True)


def test_stage_timer_accumulates():
    timers = StageTimer()
    for _ in range(2):
        with timers("a"):
            time.sleep(0.01)
    with timers("b"):
        pass
    assert timers.counts == {"a": 2, "b": 1}
    assert timers.totals["a"] >= 0.02 > timers.totals["b"]
    report = timers.report().splitlines()
    assert report[0].startswith("a") and "/ 2x" in report[0]


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64).sum()
    (path,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(path.read_text())
    assert any("aten::" in e.key for e in prof.key_averages())


def test_nan_debug_sets_anomaly_mode():
    """It sets autograd's anomaly mode, and warns that the pipeline, which
    has no backward pass, is not checked by it."""
    before = torch.is_anomaly_enabled()
    with pytest.warns(UserWarning, match="checked_ftle"), nan_debug():
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before


def test_checked_ftle():
    """Clean winds: no error, and ``ftle_pipeline``'s field; a NaN wind:
    ``throw()`` raises."""
    u, v, grid = _vortex()
    err, field = checked_ftle(u, v, -6 * 3600.0, grid, settls_order=1,
                              device="cpu")
    assert err.get() is None
    err.throw()
    want = ftle_pipeline(u, v, -6 * 3600.0, grid, settls_order=1,
                         device="cpu")
    assert torch.equal(field, want)
    bad = u.copy()
    bad[1, 5, 7] = np.nan
    err, field = checked_ftle(bad, v, -6 * 3600.0, grid, settls_order=1,
                              device="cpu")
    assert "non-finite" in err.get()
    with pytest.raises(RuntimeError, match="non-finite"):
        err.throw()
    assert field.shape == grid.shape

"""The FTLE time-series runners (lagrangiancoherence_tpu_torch/runners.py) on
the CPU: every case of tests/test_runners.py, the mesh ones through a
``batch_mesh`` of the CPU repeated, one series against the JAX package's
``ftle_series``, and files that both packages' ``utils/io.py`` read.

Each window's field is held against the port's ``ftle_pipeline`` on the same
slice (tests/test_torch_pipeline.py holds that against JAX); the JAX series
is called once, with ``batch=1``, so that it compiles one single-field
program.
"""
import glob
import os
from functools import lru_cache

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import Field, Grid, ftle_pipeline
from lagrangiancoherence_tpu_torch.models import pipeline as TP
from lagrangiancoherence_tpu_torch.parallel.mesh import batch_mesh
from lagrangiancoherence_tpu_torch.runners import (ftle_series,
                                                   ftle_series_to_files)

torch.set_num_threads(1)

DT = -6 * 3600.0
CPU = torch.device("cpu")
FTLE_RTOL = 1e-5        # tests/test_torch_pipeline.py: the port against JAX


@pytest.fixture(autouse=True)
def _float64():
    """The series computes in ``torch.get_default_dtype()``, as the facade
    does; JAX's tests run in float64."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@lru_cache(maxsize=None)
def wind_fields(nt=12):
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL, nt=nt)
    u, v, lats, lons, times = flows.ideal_vortex(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return (Field(u, dims, coords, name="u"),
            Field(v, dims, coords, name="v"), u, v, lats, lons, times)


def single(u, v, s, window, grid, **kw):
    return ftle_pipeline(u[s:s + window], v[s:s + window], DT, grid,
                         device="cpu", **kw).numpy()


class TestFtleSeries:
    def test_windows_match_single_runs(self, monkeypatch):
        """Each window equals the one-call pipeline on its slice, and the
        series builds its grid state once."""
        U, V, u, v, lats, lons, times = wind_fields()
        grid = Grid(lats=lats, lons=lons, cyclic_x=True)
        built = []
        real = TP.grid_state
        monkeypatch.setattr(TP, "grid_state",
                            lambda *a, **k: built.append(1) or real(*a, **k))
        series = ftle_series(U, V, DT, window=5, stride=3, settls_order=1,
                             batch=2, device="cpu")
        assert len(built) == 1
        starts = [0, 3, 6]
        assert series.shape[0] == len(starts)
        for i, s in enumerate(starts):
            np.testing.assert_array_equal(
                series.data[i], single(u, v, s, 5, grid, settls_order=1))
            # a backward run stamps the window's first time (LCS.py:158)
            assert series.coords["time"][i] == times[s]

    def test_forward_stamps_last(self):
        U, V, *_, times = wind_fields()
        series = ftle_series(U, V, -DT, window=5, stride=5, settls_order=0,
                             device="cpu")
        assert series.coords["time"][0] == times[4]

    def test_sharded_batch(self):
        U, V, *_ = wind_fields()
        a = ftle_series(U, V, DT, window=5, stride=2, settls_order=1,
                        batch=4, mesh=batch_mesh(devices=[CPU] * 4))
        b = ftle_series(U, V, DT, window=5, stride=2, settls_order=1,
                        batch=4, device="cpu")
        np.testing.assert_array_equal(a.data, b.data)

    def test_too_short_record_raises(self):
        U, V, *_ = wind_fields(nt=4)
        with pytest.raises(ValueError):
            ftle_series(U, V, DT, window=10, device="cpu")

    def test_plain_arrays_refused(self):
        *_, u, v, lats, lons, times = wind_fields()
        with pytest.raises(TypeError, match="Fields"):
            ftle_series(u, v, DT, window=5, device="cpu")

    def test_matches_jax_series(self):
        """One series against the JAX package's, within the pipeline's
        bound."""
        from lagrangiancoherence_tpu.field import Field as JaxField
        from lagrangiancoherence_tpu.runners import ftle_series as jax_series
        U, V, u, v, lats, lons, times = wind_fields()
        dims = ("time", "latitude", "longitude")
        coords = dict(time=times, latitude=lats, longitude=lons)
        want = jax_series(JaxField(u, dims, coords, name="u"),
                          JaxField(v, dims, coords, name="v"), DT,
                          window=5, stride=5, settls_order=1, batch=1)
        got = ftle_series(U, V, DT, window=5, stride=5, settls_order=1,
                          batch=1, device="cpu")
        np.testing.assert_array_equal(got.coords["time"],
                                      np.asarray(want.coords["time"]))
        w = np.asarray(want.data)
        assert got.shape == w.shape == (2,) + u.shape[1:]
        assert np.nanmax(np.abs(got.data - w)) <= FTLE_RTOL * np.nanmax(
            np.abs(w))


class TestStreaming:
    def test_idempotent_files(self, tmp_path):
        pytest.importorskip("h5py")
        U, V, *_ = wind_fields()
        out = str(tmp_path / "anim")
        w1 = ftle_series_to_files(U, V, DT, out, window=5, stride=5,
                                  settls_order=0, device="cpu")
        assert len(w1) == 2
        assert all(os.path.exists(p) for p in w1)
        # a second run skips everything (crash-recovery contract)
        w2 = ftle_series_to_files(U, V, DT, out, window=5, stride=5,
                                  settls_order=0, device="cpu")
        assert w2 == []

    def test_files_readable_by_both_packages(self, tmp_path):
        pytest.importorskip("h5py")
        from lagrangiancoherence_tpu.utils.io import \
            open_dataset as jax_open
        from lagrangiancoherence_tpu_torch.utils.io import open_dataset
        U, V, *_, times = wind_fields()
        series = ftle_series(U, V, DT, window=5, stride=5, settls_order=1,
                             device="cpu")
        paths = ftle_series_to_files(U, V, DT, str(tmp_path), window=5,
                                     stride=5, settls_order=1, device="cpu")
        assert [os.path.basename(p) for p in paths] == [
            "ftle_2000-01-01T00.nc", "ftle_2000-01-02T06.nc"]
        for i, path in enumerate(paths):
            for ds in (open_dataset(path), jax_open(path)):
                f = ds["ftle"]
                assert tuple(f.dims) == ("time", "latitude", "longitude")
                np.testing.assert_array_equal(np.asarray(f.data)[0],
                                              series.data[i])
                assert np.asarray(f.coords["time"])[0] == \
                    series.coords["time"][i]

    def test_resume_recomputes_only_missing(self, tmp_path, monkeypatch):
        """Resume after a partial run skips compute, not just writes, and
        finished windows survive a mid-series crash (streamed writes)."""
        pytest.importorskip("h5py")
        calls = []
        real = TP.FTLEPipeline.forward

        def counting(self, *a, **k):
            calls.append(1)
            return real(self, *a, **k)

        monkeypatch.setattr(TP.FTLEPipeline, "forward", counting)
        U, V, *_ = wind_fields()
        out = str(tmp_path / "anim")
        # batch=1: one window a chunk
        w1 = ftle_series_to_files(U, V, DT, out, window=5, stride=5,
                                  settls_order=0, batch=1, device="cpu")
        assert len(w1) == 2 and len(calls) == 2
        # a crash that lost the second window
        os.remove(w1[1])
        calls.clear()
        w2 = ftle_series_to_files(U, V, DT, out, window=5, stride=5,
                                  settls_order=0, batch=1, device="cpu")
        assert w2 == [w1[1]]
        assert len(calls) == 1          # only the missing window recomputed

    def test_streams_per_chunk(self, tmp_path, monkeypatch):
        """Each chunk's files exist on disk before the next chunk's compute
        starts: a crash loses at most one chunk of work."""
        pytest.importorskip("h5py")
        seen_on_disk = []
        real = TP.FTLEPipeline.forward
        outdir = str(tmp_path / "anim")

        def spying(self, *a, **k):
            seen_on_disk.append(len(glob.glob(os.path.join(outdir, "*.nc"))))
            return real(self, *a, **k)

        monkeypatch.setattr(TP.FTLEPipeline, "forward", spying)
        U, V, *_ = wind_fields()
        w = ftle_series_to_files(U, V, DT, outdir, window=5, stride=5,
                                 settls_order=0, batch=1, device="cpu")
        assert len(w) == 2
        # the second window's compute saw the first window written
        assert seen_on_disk == [0, 1]


class TestSeriesOptions:
    def test_regional_cyclic_x_false(self):
        """Regional records (the reference's research workload,
        area_of_influence.py:168-184) get no dateline wrap."""
        U, V, u, v, lats, lons, times = wind_fields()
        grid = Grid(lats=lats, lons=lons, cyclic_x=False)
        series = ftle_series(U, V, DT, window=5, stride=5, settls_order=1,
                             batch=1, cyclic_x=False, device="cpu")
        np.testing.assert_array_equal(series.data[0],
                                      single(u, v, 0, 5, grid,
                                             settls_order=1))

    def test_mesh_overflow_warning(self, monkeypatch, caplog):
        """The mesh branch carries the overflow words into the series'
        warning (the flag is never dropped)."""
        import lagrangiancoherence_tpu_torch.parallel.pipeline as pp

        def fake_batch(ub, vb, timestep, grid, mesh, *,
                       return_overflow=False, **kw):
            out = torch.zeros((ub.shape[0],) + grid.shape)
            flags = torch.ones(ub.shape[0], dtype=torch.int32)
            return (out, flags) if return_overflow else out

        monkeypatch.setattr(pp, "ftle_batch", fake_batch)
        U, V, *_ = wind_fields()
        with caplog.at_level("WARNING",
                             logger="lagrangiancoherence_tpu_torch"):
            ftle_series(U, V, DT, window=5, stride=5, settls_order=0,
                        batch=2, mesh=batch_mesh(devices=[CPU] * 2))
        assert any("clamped" in r.message for r in caplog.records)

    def test_mesh_tail_chunk_padded(self):
        """A tail chunk smaller than the device count is padded so that
        every device takes a share, and ``batch="auto"`` stays a multiple
        of the device count."""
        U, V, *_ = wind_fields()
        mesh = batch_mesh(devices=[CPU] * 2)
        # stride=2: 4 windows; batch=3 on 2 devices: chunks of 3 (padded to
        # 4) and 1 (padded to 2)
        a = ftle_series(U, V, DT, window=5, stride=2, settls_order=1,
                        batch=3, mesh=mesh)
        b = ftle_series(U, V, DT, window=5, stride=2, settls_order=1,
                        batch=4, device="cpu")
        np.testing.assert_array_equal(a.data, b.data)
        c = ftle_series(U, V, DT, window=5, stride=2, settls_order=1,
                        mesh=batch_mesh(devices=[CPU] * 3))
        np.testing.assert_array_equal(c.data, b.data)

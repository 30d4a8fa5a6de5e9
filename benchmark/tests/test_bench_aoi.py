"""The ``aoi-box`` cell on the CPU at a small size: its entry end to end,
the readers of a case's spans, the control, and the faults its comparison
has to catch (a skeleton pixel flipped, a filtered component dropped, a
case's FTLE stamped with another time, a stage come out empty)."""
import copy
import time

import numpy as np
import pytest
import torch

import lagrangiancoherence_tpu_torch.examples.area_of_influence as A
from benchmark import calibrate, harness, moisture
from benchmark.harness import Run
from _small import SEED

NAME = "aoi-box"


def small(ny: int = 61, nx: int = 65) -> dict:
    c = copy.deepcopy(harness.cell(NAME))
    c["config"]["grid"].update(ny=ny, nx=nx)
    return c


def _run(c, traced=False):
    return harness.run_cell(NAME, SEED, 0.2, traced, torch.device("cpu"),
                            time.perf_counter(), c=c, log=lambda *a: None)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_cell_runs_on_cpu(traced):
    c = small()
    out = _run(c, traced)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == set(c["limits"]["limits"])
    names = {m["name"] for m in (c["per_layer"] if traced
                                 else c["end_to_end"])}
    if traced:
        # the spans are read on the CPU too; the device's readers stay
        # silent without a card
        assert {"aoi_lcs_ms", "aoi_ridges_ms", "aoi_skeleton_ms",
                "aoi_filter_ms"} <= set(out["metrics"]) <= names
        assert not any(n.startswith(("device_idle", "skeleton_host"))
                       for n in out["metrics"])
    else:
        assert set(out["metrics"]) == names


def test_fields_are_seeded():
    spec = harness.cell(NAME)["traffic"]["fields"]
    lats, lons = np.linspace(15, -40, 23), np.linspace(-90, -32, 25)
    a = moisture.fields_numpy(moisture.draw(spec, SEED, 1), spec, lats, lons,
                              3)
    b = moisture.fields_numpy(moisture.draw(spec, SEED, 1), spec, lats, lons,
                              3)
    c = moisture.fields_numpy(moisture.draw(spec, SEED, 2), spec, lats, lons,
                              3)
    assert set(a) == set(moisture.NAMES)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == (3, 23, 25) and a[k].dtype == np.float64
    assert not np.array_equal(a["viwve"], c["viwve"])
    lo, hi = spec["tcwv"]
    assert lo <= a["tcwv"].min() and a["tcwv"].max() <= hi
    assert 0 <= a["pr"].min() and a["pr"].max() <= spec["rain_mm_day"][1]


def test_control_fails_and_program_passes():
    c = small()
    device = torch.device("cpu")
    drv = harness.entry("aoi")(c["config"], c["traffic"], SEED, device)
    sample = harness.Reservoir(c["traffic"]["sample_calls"], SEED)
    harness.window(drv, 0.2, sample, device)
    answers = sample.answers()
    drv.release()
    limits = c["limits"]["limits"]
    prog = calibrate.readings(*drv.check(answers, device))
    ctl = calibrate.readings(*drv.check(answers, device, "control"))
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in ctl if k in limits), ctl


def _skeleton_pixel_flipped(monkeypatch):
    sk = A.skeletonize

    def flip(mask, **kw):
        out = sk(mask, **kw).clone()
        out[out.shape[0] // 2, out.shape[1] // 2] = 1 - out[
            out.shape[0] // 2, out.shape[1] // 2]
        return out
    monkeypatch.setattr(A, "skeletonize", flip)


def _component_dropped(monkeypatch):
    fr, calls = A.filter_ridges, []

    def drop(ridges, *a, **k):
        out = fr(ridges, *a, **k)
        calls.append(1)
        if len(calls) % 2 == 1:       # the FTLE filter of each case
            from scipy import ndimage
            data = out.data.copy()
            lab, n = ndimage.label(~np.isnan(data), structure=np.ones((3, 3)))
            if n:
                data[lab == 1] = np.nan
            out = out.copy(data=data)
        return out
    monkeypatch.setattr(A, "filter_ridges", drop)


def _stamp_from_another_case(monkeypatch):
    call = A.LCS.__call__

    def shifted(self, *a, **k):
        out = call(self, *a, **k)
        t = out.coords["time"] + np.timedelta64(6, "h")
        return out.assign_coords(time=t)
    monkeypatch.setattr(A.LCS, "__call__", shifted)


def _stage_empty(monkeypatch):
    fr, calls = A.filter_ridges, []

    def none_kept(ridges, intensity, criteria, thresholds):
        calls.append(1)
        if len(calls) % 2 == 0:       # the pressure-gradient filter
            thresholds = [np.inf] * len(thresholds)
        return fr(ridges, intensity, criteria, thresholds)
    monkeypatch.setattr(A, "filter_ridges", none_kept)


FAULTS = {"skeleton_pixel_flipped": (_skeleton_pixel_flipped,
                                     "skeleton_mismatch"),
          "component_dropped": (_component_dropped, "filter_mismatch"),
          "stamp_from_another_case": (_stamp_from_another_case,
                                      "stamp_mismatch"),
          "stage_empty": (_stage_empty, "empty_case")}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails_its_number(fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    out = _run(small())
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


SPANS = [("LCS call", 0.30), ("Local threshold", 0.01),
         ("Hessian ridges", 0.02), ("Skeletonize", 0.05),
         ("Ridge filter", 0.003), ("Ridge filter", 0.001),
         ("Pressure-gradient classification", 0.01), ("LCS call", 0.10),
         ("AOI case", 0.6),
         ("LCS call", 0.20), ("LCS call", 0.05), ("Hessian ridges", 0.04),
         ("Skeletonize", 0.07), ("Ridge filter", 0.002), ("AOI case", 0.5),
         ("LCS call", 0.5), ("Skeletonize", 0.09), ("AOI case", 0.7)]


@pytest.mark.parametrize("metric,want", [
    ("aoi_lcs_ms", 400.0),              # 400, 250, 500
    ("aoi_ridges_ms", 20.0),            # 20, 40, 0
    ("aoi_skeleton_ms", 70.0),          # 50, 70, 90
    ("aoi_filter_ms", 2.0),             # 4, 2, 0
])
def test_case_span_readers(metric, want):
    """Each case's spans are those closed since the last "AOI case" record;
    a reader sums its spans in each case and takes the median."""
    assert harness.reader(metric).read(Run(spans=SPANS, calls=3)) \
        == pytest.approx(want)


@pytest.mark.parametrize("metric", ["aoi_lcs_ms", "aoi_ridges_ms",
                                    "aoi_skeleton_ms", "aoi_filter_ms"])
def test_case_span_readers_without_a_case(metric):
    assert harness.reader(metric).read(
        Run(spans=[("LCS call", 0.3), ("Skeletonize", 0.1)], calls=1)) is None
    assert harness.reader(metric).read(
        Run(spans=[("Series call", 0.3), ("AOI case", 0.1)], calls=1)) is None


def _ev(name, cat, ts, dur=1.0):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "args": {}}


def test_skeleton_waits_counted_inside_skeletonize_only():
    events = [
        _ev("Skeletonize", "user_annotation", 100.0, 100.0),
        _ev("Skeletonize", "user_annotation", 300.0, 50.0),
        _ev("Hessian ridges", "user_annotation", 20.0, 50.0),
        _ev("cudaStreamSynchronize", "cuda_runtime", 130.0),    # counted
        _ev("cudaMemcpyAsync", "cuda_runtime", 131.0),          # no wait
        _ev("cudaMemcpy", "cuda_runtime", 310.0),               # counted
        _ev("cudaStreamSynchronize", "cuda_runtime", 30.0),     # ridges
        _ev("cudaStreamSynchronize", "cpu_op", 140.0),          # not runtime
        _ev("kernel_a", "kernel", 135.0),
    ]
    run = Run(stack={"events": events}, stack_units=2)
    r = harness.reader("skeleton_host_waits_per_case")
    assert r.read(run) == pytest.approx(1.0)
    no_span = [e for e in events if e["name"] != "Skeletonize"]
    assert r.read(Run(stack={"events": no_span}, stack_units=2)) is None
    no_card = [e for e in events if e["cat"] != "kernel"]
    assert r.read(Run(stack={"events": no_card}, stack_units=2)) is None

"""Every fault a cell can have, planted under the timed path, turns
``correct`` false: a step that returns its state unchanged, half of the
parcels left out of the integration, an answer altered where it is made,
and for the series a window's field or stamp taken from another window.
(No cell spans chips, so no exchange between chips can be left out.)"""
import time

import pytest
import torch

import lagrangiancoherence_tpu_torch.api as api
import lagrangiancoherence_tpu_torch.models.pipeline as pipeline
import lagrangiancoherence_tpu_torch.models.settls as settls
import lagrangiancoherence_tpu_torch.runners as runners
from benchmark import harness
from _small import CELLS, SEED, small


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(settls, "settls_step_torch",
                        lambda f, c, px, py, *a, **k: (px.clone(),
                                                       py.clone()))


def _half_left_out(monkeypatch):
    step = settls.settls_step_torch

    def half(f, c, px, py, *a, **k):
        nx, ny = step(f, c, px, py, *a, **k)
        h = px.shape[0] // 2
        nx, ny = nx.clone(), ny.clone()
        nx[h:], ny[h:] = px[h:], py[h:]
        return nx, ny
    monkeypatch.setattr(settls, "settls_step_torch", half)


def _answer_altered(monkeypatch):
    norm = pipeline.ftle_norm
    monkeypatch.setattr(pipeline, "ftle_norm",
                        lambda *a, **k: norm(*a, **k) * 1.05)
    ftle = api.ftle_from_departures
    monkeypatch.setattr(api, "ftle_from_departures",
                        lambda *a, **k: ftle(*a, **k) * 1.05)


def _window_repeated(monkeypatch):
    forward, last = pipeline.FTLEPipeline.forward, {}

    def repeat(self, *a, **k):
        n = last.get("n", 0)
        last["n"] = n + 1
        if n % 2 == 0 or "out" not in last:
            last["out"] = forward(self, *a, **k)
        return last["out"]
    monkeypatch.setattr(pipeline.FTLEPipeline, "forward", repeat)


def _stamp_shifted(monkeypatch):
    stamps = runners._stamp_indices
    monkeypatch.setattr(runners, "_stamp_indices",
                        lambda *a: [i + 1 for i in stamps(*a)])


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
SERIES_FAULTS = {"window_repeated": _window_repeated,
                 "stamp_shifted": _stamp_shifted}
CASES = ([(c, f) for c in CELLS for f in FAULTS]
         + [("global-series-month", f) for f in SERIES_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_fails_correct(name, fault, monkeypatch):
    c = small(name)
    {**FAULTS, **SERIES_FAULTS}[fault](monkeypatch)
    out = harness.run_cell(name, SEED, 0.2, False, torch.device("cpu"),
                           time.perf_counter(), c=c, log=lambda *a: None)
    assert out["correct"] is False
    assert out["failed"] >= 1


def _row_altered(monkeypatch):
    """One row of the answer altered 5%: a fault confined to a few points,
    as one in the pole-home rows or at a block's edge would be."""
    def alter(f):
        f = f.clone()
        f[f.shape[-2] // 2 + 3] *= 1.05
        return f
    norm = pipeline.ftle_norm
    monkeypatch.setattr(pipeline, "ftle_norm",
                        lambda *a, **k: alter(norm(*a, **k)))
    ftle = api.ftle_from_departures
    monkeypatch.setattr(api, "ftle_from_departures",
                        lambda *a, **k: alter(ftle(*a, **k)))


@pytest.mark.parametrize("name", CELLS)
def test_row_fault_fails_correct(name, monkeypatch):
    """The percentiles miss a fault in one row of 35; the largest median
    of a row catches it."""
    c = small(name)
    _row_altered(monkeypatch)
    out = harness.run_cell(name, SEED, 0.2, False, torch.device("cpu"),
                           time.perf_counter(), c=c, log=lambda *a: None)
    assert out["correct"] is False
    assert out["checks"]["ftle_err_line_max"]["value"] \
        > out["checks"]["ftle_err_line_max"]["limit"]

"""A cell's cards: the configuration's ``cards`` set the cell's devices,
``harness.cell`` refuses a cell whose ``chips`` differ, every card is
waited on, and the result line's ``device`` records every card.  On the
CPU, with the CUDA calls that would reach a card replaced by recorders."""
import copy
import json

import pytest
import torch

from benchmark import harness
from benchmark import trace as T
from test_bench_trace import _trace, _two_cards

MAN = harness.load_json(harness.ROOT / "BENCHMARK.json")
CUDA = [torch.device("cuda", i) for i in range(4)]


def _with_config(tmp_path, cards, chips) -> dict:
    """The manifest with ``global-resident``'s configuration stating
    ``cards`` (left out where None) and the cell asking for ``chips``."""
    man = copy.deepcopy(MAN)
    cfg = harness.load_json(harness.ROOT / "benchmark" / "configs"
                            / "era5-0p25-global.json")
    if cards is not None:
        cfg["cards"] = cards
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    man["configs"].append({"name": "cards-test", "source": "test",
                           "file": str(path), "reduced": [], "why": "test"})
    w = next(w for w in man["workloads"] if w["name"] == "global-resident")
    w.update(config="cards-test", chips=chips)
    return man


@pytest.mark.parametrize("cards, chips", [(None, 4), (1, 4), (4, 1)])
def test_cell_refuses_chips_other_than_cards(tmp_path, cards, chips):
    with pytest.raises(SystemExit, match="chip"):
        harness.cell("global-resident", _with_config(tmp_path, cards, chips))


@pytest.mark.parametrize("cards, chips", [(None, 1), (1, 1), (4, 4)])
def test_cell_takes_chips_equal_to_cards(tmp_path, cards, chips):
    c = harness.cell("global-resident", _with_config(tmp_path, cards, chips))
    assert c["entry"]["chips"] == chips
    assert c["config"].get("cards", 1) == chips


@pytest.mark.parametrize("cfg, device, want", [
    ({}, torch.device("cuda", 0), CUDA[:1]),
    ({"cards": 1}, torch.device("cuda", 0), CUDA[:1]),
    ({"cards": 4}, torch.device("cuda", 0), CUDA),
    ({"cards": 2}, torch.device("cuda", 2), CUDA[2:]),
    ({"cards": 4}, torch.device("cpu"), [torch.device("cpu")] * 4),
    ({}, torch.device("cpu"), [torch.device("cpu")]),
])
def test_cards(cfg, device, want):
    assert harness.cards(cfg, device) == want


@pytest.fixture
def synced(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: seen.append(d))
    return seen


class _Drv:
    units_per_call = 1

    def call(self, i):
        return i

    def keep(self, i, out):
        return [(i, out)]


@pytest.mark.parametrize("n", [1, 4])
def test_window_waits_on_every_card(synced, n):
    harness.window(_Drv(), 0.0, harness.Reservoir(1, 5), CUDA[:n])
    # before the first call and after the last, each card once
    assert synced == CUDA[:n] * 2


def test_one_card_is_one_synchronise(synced):
    T.sync(CUDA[:1])
    T.sync([torch.device("cpu")] * 3)
    assert synced == [torch.device("cuda", 0)]


def test_device_record_on_the_cpu():
    assert harness.device_record([torch.device("cpu")]) == {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0, "memory_peak_bytes_per_card": []}
    assert harness.device_record([torch.device("cpu")] * 4)["count"] == 0


@pytest.fixture
def peaks(monkeypatch):
    """Cards whose peaks are known: card i peaked at PEAKS[i] bytes."""
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: PEAKS[torch.device(d).index])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "smi", lambda d, f: ["700.00 W"])


PEAKS = [5_000_000_000, 9_000_000_000, 7_000_000_000, 3_000_000_000]


def test_device_record_of_four_cards(peaks):
    rec = harness.device_record(CUDA)
    assert rec == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4, "memory_peak_bytes": 9_000_000_000,
                   "memory_peak_bytes_per_card": PEAKS,
                   "power_limit": "700.00 W"}


def test_device_record_of_one_card_as_before(peaks):
    rec = harness.device_record(CUDA[:1])
    # the single card's record as it read before cells could take more
    assert {k: rec[k] for k in ("platform", "kind", "count",
                                "memory_peak_bytes")} == {
        "platform": "gpu", "kind": torch.cuda.get_device_name(CUDA[0]),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(CUDA[0]))}
    assert rec["memory_peak_bytes_per_card"] == [PEAKS[0]]


class _Entry(_Drv):
    """A throwaway entry point: nothing sampled, nothing compared."""

    def __init__(self, cfg, traffic, seed, device):
        pass

    def release(self):
        pass

    def check(self, answers, device):
        return [], {}


@pytest.mark.parametrize("n, trace, busy", [
    (1, _trace, [150e-6]),
    (2, _two_cards, [200e-6, 100e-6]),
])
def test_line_reads_every_card_busy(monkeypatch, synced, peaks, n, trace,
                                    busy):
    """A traced line's ``device``: ``busy_s_per_card`` card by card and
    ``busy_s`` their mean; on one card the mean is the union of every
    device operation, the number the line gave before, bit for bit."""
    monkeypatch.setattr(harness, "entry", lambda name: _Entry)
    monkeypatch.setattr(T, "profile", lambda *a, **k: trace())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    c = {"config": {"cards": n, "tf32": False},
         "traffic": {"entry": "throwaway", "sample_calls": 1,
                     "profile_calls": 2},
         "per_layer": [], "end_to_end": [], "limits": {"limits": {}}}
    out = harness.run_cell("throwaway", 5, 0.0, True, CUDA[0],
                           0.0, c=c, log=lambda *a: None)
    dev = out["device"]
    assert dev["busy_s_per_card"] == [pytest.approx(b) for b in busy]
    assert dev["busy_s"] == pytest.approx(sum(busy) / n)
    assert dev["count"] == n
    s = T.device_summary(trace())
    assert dev["window_s"] == s["window_s"]
    if n == 1:
        assert dev["busy_s"] == s["busy_s"]

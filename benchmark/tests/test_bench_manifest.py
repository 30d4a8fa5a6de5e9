"""BENCHMARK.json against the rules the harness is built to: names and
units, metrics and their cells, files found by name, chips and run length.
A cell takes 1 or 4 chips, as many as its configuration's ``cards``, and at
most max(1, cells // 4) cells take 4.
"""
import json
from pathlib import Path
import re

import pytest

ROOT = Path(__file__).resolve().parents[2]

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # 2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s of compile a cell
    # and 1200 s spare fit 43200 s even at the full 24 cells
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24 and len((ROOT / "BENCHMARK.json").read_bytes()) \
        <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")


def test_unique_and_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_chips(w):
    assert w["chips"] in (1, 4)
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file() and conf["reduced"] == []
    traffic = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
    entry = json.loads(traffic.read_text())["entry"]
    assert (ROOT / "benchmark" / "entries" / f"{entry}.py").is_file()
    limits = json.loads((ROOT / "benchmark" / "limits"
                         / f"{w['name']}.json").read_text())
    assert limits["limits"]


def chips_breaches(workloads: list, cards: dict) -> list[str]:
    """What breaks the rule on chips: more four-card cells than
    max(1, cells // 4), or a cell whose ``chips`` differ from the ``cards``
    its configuration states (``cards``: configuration name to cards)."""
    out = []
    four = sum(w["chips"] == 4 for w in workloads)
    if four > max(1, len(workloads) // 4):
        out.append(f"{four} four-card cells of {len(workloads)}")
    out += [f"{w['name']}: chips {w['chips']}, cards {cards[w['config']]}"
            for w in workloads if w["chips"] != cards[w["config"]]]
    return out


def test_four_card_share_and_cards():
    cards = {c["name"]: json.loads((ROOT / c["file"]).read_text()).get(
        "cards", 1) for c in MAN["configs"]}
    assert chips_breaches(MAN["workloads"], cards) == []


def _manifest(cells: int, four: int) -> list:
    return [{"name": f"w{i}", "config": "four" if i < four else "one",
             "chips": 4 if i < four else 1} for i in range(cells)]


@pytest.mark.parametrize("cells, four, ok", [
    (1, 1, True), (3, 1, True), (4, 1, True), (4, 2, False), (7, 2, False),
    (8, 2, True), (8, 3, False), (24, 6, True), (24, 7, False)])
def test_four_card_share_at_and_beyond_the_limit(cells, four, ok):
    breaches = chips_breaches(_manifest(cells, four), {"one": 1, "four": 4})
    assert (breaches == []) is ok, breaches


def test_cards_must_match_chips():
    w = _manifest(4, 1)
    assert chips_breaches(w, {"one": 1, "four": 1}) == ["w0: chips 4, cards 1"]
    w[0]["chips"] = 1
    assert chips_breaches(w, {"one": 1, "four": 4}) == ["w0: chips 1, cards 4"]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_has_reader(m):
    from benchmark import harness
    assert harness.reader_path(m["name"]).is_file()
    assert callable(harness.reader(m["name"]).read)
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in MAN["workloads"]}


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell(m):
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for cell in m["workloads"]:
        assert _reports(cell, e2e[m["moves"]])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports(w):
    e2e = [m["name"] for m in MAN["end_to_end"] if _reports(w["name"], m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(w["name"], m) for m in MAN["per_layer"])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in MAN["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25

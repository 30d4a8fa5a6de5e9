"""Reading a trace: the traced window runs from the first call after the
lead ones to the later of the last call's end and the last device
operation's, by the trace's own timestamps; busy time is the union of
device operations inside it, and each card's the union of its own; gaps
are labelled by what the host did."""
import pytest

from benchmark import trace as T


def _ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _trace():
    return {"wall_s": 1.0, "lead": 1, "calls": 2, "events": [
        _ev("bench.stretch", "user_annotation", 0.0, 400.0),
        _ev("bench.call", "user_annotation", 0.0, 100.0),    # lead: not read
        _ev("bench.call", "user_annotation", 100.0, 100.0),
        _ev("bench.call", "user_annotation", 200.0, 150.0),
        _ev("aten::sort", "cpu_op", 210.0, 60.0),
        _ev("k_lead", "kernel", 20.0, 90.0),      # 10 us inside the window
        _ev("k1", "kernel", 120.0, 40.0),
        _ev("k2", "kernel", 150.0, 30.0),         # overlaps k1: union 60
        _ev("memcpy", "gpu_memcpy", 300.0, 80.0),  # ends after the calls
    ]}


def test_window_and_busy_from_the_trace():
    s = T.device_summary(_trace())
    # window 100 .. 380 us; busy 10 + 60 + 80 = 150 us
    assert s["window_s"] == pytest.approx(280e-6)
    assert s["busy_s"] == pytest.approx(150e-6)
    gaps = dict((lab, sec) for lab, sec in s["idle_gaps"])
    # the longest gap, 180 .. 300 us, lies in the host's sort
    assert s["idle_gaps"][0] == ["host: aten::sort", pytest.approx(120e-6)]
    assert sum(gaps.values()) == pytest.approx(130e-6)
    ops = dict(s["device_ops"])
    assert ops["k_lead"] == pytest.approx(10e-6)


def test_without_call_marks_the_host_clock_stands():
    t = _trace()
    t["events"] = [e for e in t["events"] if e["name"] != "bench.call"]
    s = T.device_summary(t)
    assert s["window_s"] == pytest.approx(1.0)


def test_one_card_by_hand():
    s = T.device_summary(_trace())
    # window 100 .. 380 us; k_lead clipped to 100 .. 110, k1 and k2 merge
    # into 120 .. 180, the copy 300 .. 380
    assert s["window_s"] == pytest.approx(280e-6)
    assert s["busy_s"] == pytest.approx(150e-6)
    # one card's busy time is the union, bit for bit
    assert s["busy_s_per_card"] == {0: s["busy_s"]}
    assert s["device_ops"] == [["memcpy", pytest.approx(80e-6)],
                               ["k1", pytest.approx(40e-6)],
                               ["k2", pytest.approx(30e-6)],
                               ["k_lead", pytest.approx(10e-6)]]
    # 180 .. 300 in the host's sort; 110 .. 120 after the lead call
    assert s["idle_gaps"] == [["host: aten::sort", pytest.approx(120e-6)],
                              ["host after: bench.call",
                               pytest.approx(10e-6)]]
    assert s["device_op_count"] == 4


def _two_cards():
    """Card 0 busy over the whole window 100 .. 300 us, card 1 over its
    first half."""
    return {"wall_s": 1.0, "lead": 1, "calls": 2, "events": [
        _ev("bench.call", "user_annotation", 0.0, 100.0),
        _ev("bench.call", "user_annotation", 100.0, 100.0),
        _ev("bench.call", "user_annotation", 200.0, 100.0),
        _ev("a0", "kernel", 100.0, 120.0, device=0),
        _ev("b0", "kernel", 220.0, 80.0, device=0),
        _ev("a1", "kernel", 100.0, 60.0, device=1),
        _ev("c1", "gpu_memcpy", 150.0, 50.0, device=1),   # overlaps a1
    ]}


def test_two_cards_each_read_and_the_union_unchanged():
    s = T.device_summary(_two_cards())
    assert s["busy_s_per_card"] == {0: pytest.approx(200e-6),
                                    1: pytest.approx(100e-6)}
    # the same operations on one card give the same union, window, ops
    # and gaps: only the per-card split is new
    one = _two_cards()
    for e in one["events"]:
        e["args"].pop("device", None)
    u = T.device_summary(one)
    assert u["busy_s_per_card"] == {0: pytest.approx(200e-6)}
    for k in ("busy_s", "window_s", "device_ops", "idle_gaps",
              "device_op_count"):
        assert s[k] == u[k], k
    assert s["busy_s"] == pytest.approx(200e-6)
    assert s["window_s"] == pytest.approx(200e-6)

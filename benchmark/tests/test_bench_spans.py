"""The readers of the program's spans: the facade's sort, the series'
prep, upload and assembly (its ``timed_stage`` records), and the host's
waits inside the pipeline's "FTLE field" (the stack trace's
``user_annotation`` ranges), on synthetic runs and trace events."""
import pytest

from benchmark import harness
from benchmark.harness import Run

MONTH = harness.cell("global-series-month")


def _reader(name):
    return harness.reader(name)


def _ev(name, cat, ts, dur=1.0):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "args": {}}


SPAN_READERS = {
    "facade_sort_ms": "Sort to ascending coordinates",
    "series_record_prep_ms": "Series record prep",
    "series_assembly_ms": "Series assembly",
}


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_span_ms_a_call(metric):
    """The span's seconds, summed over the window, over its calls, in
    ms; other spans take no part."""
    span = SPAN_READERS[metric]
    run = Run(calls=2, spans=[(span, 0.10), ("LCS call", 5.0), (span, 0.05),
                              (span, 0.15), ("Series call", 3.0)])
    assert _reader(metric).read(run) == pytest.approx(150.0)


@pytest.mark.parametrize("metric", list(SPAN_READERS)
                         + ["series_upload_gbps"])
def test_missing_span_gives_none(metric):
    run = Run(calls=3, spans=[("Regrid to common global grid", 0.1)],
              cfg=MONTH["config"], traffic=MONTH["traffic"])
    assert _reader(metric).read(run) is None


def test_upload_bytes_at_the_months_size():
    r = _reader("series_upload_gbps")
    g = MONTH["config"]["grid"]
    assert (MONTH["traffic"]["record_levels"], g["ny"], g["nx"],
            MONTH["config"]["dtype"]) == (124, 721, 1440, "float32")
    assert r.bytes_per_call(124, 721, 1440, 4) == 1_029_934_080


def test_upload_rate():
    """Bytes computed a call, times the calls, over the summed seconds of
    the upload spans (one a call: None otherwise)."""
    r = _reader("series_upload_gbps")
    spans = [("Series record upload", 0.2), ("Series record prep", 0.5),
             ("Series record upload", 0.3)]
    run = Run(calls=2, spans=spans, cfg=MONTH["config"],
              traffic=MONTH["traffic"])
    assert r.read(run) == pytest.approx(2 * 1.02993408 / 0.5)
    run.calls = 3
    assert r.read(run) is None


def _stack(events):
    return {"events": events, "wall_s": 1.0, "calls": 2, "lead": 0}


def test_waits_counted_inside_ftle_field_only():
    """Blocking runtime calls that start inside an "FTLE field" range are
    counted, over the stretch's fields; those outside it, other runtime
    calls and host events of the same name are not."""
    events = [
        _ev("FTLE field", "user_annotation", 100.0, 100.0),
        _ev("FTLE field", "user_annotation", 300.0, 100.0),
        _ev("SETTLS loop", "user_annotation", 120.0, 50.0),
        _ev("cudaStreamSynchronize", "cuda_runtime", 130.0),    # counted
        _ev("cudaMemcpyAsync", "cuda_runtime", 129.0),          # no wait
        _ev("cudaDeviceSynchronize", "cuda_runtime", 199.5),    # counted
        _ev("cudaEventSynchronize", "cuda_runtime", 310.0),     # counted
        _ev("cudaMemcpy", "cuda_runtime", 320.0),               # counted
        _ev("cudaStreamSynchronize", "cuda_runtime", 250.0),    # between
        _ev("cudaStreamSynchronize", "cuda_runtime", 450.0),    # after
        _ev("cudaStreamSynchronize", "cpu_op", 140.0),          # not runtime
        _ev("kernel_a", "kernel", 135.0),
    ]
    run = Run(stack=_stack(events), stack_units=2)
    assert _reader("host_waits_per_field").read(run) == pytest.approx(2.0)


def test_waits_without_the_span_or_the_card_give_none():
    r = _reader("host_waits_per_field")
    events = [_ev("cudaStreamSynchronize", "cuda_runtime", 130.0),
              _ev("kernel_a", "kernel", 135.0)]
    assert r.read(Run(stack=_stack(events), stack_units=3)) is None
    cpu_only = [_ev("FTLE field", "user_annotation", 100.0, 100.0),
                _ev("aten::mm", "cpu_op", 110.0)]
    assert r.read(Run(stack=_stack(cpu_only), stack_units=3)) is None
    # a field with no wait reads 0, not None
    quiet = [_ev("FTLE field", "user_annotation", 100.0, 100.0),
             _ev("kernel_a", "kernel", 135.0)]
    assert r.read(Run(stack=_stack(quiet), stack_units=3)) == 0.0

"""The port's spans (``utils/logging.timed_stage``) on the CPU: the log
record the benchmark's ``SpanLog`` parses, the span identifiers, the
profiler ranges, and the spans each layer opens (the facade, the series
runner, the pipeline)."""
import json
import logging

import pytest
import torch

from lagrangiancoherence_tpu_torch import LCS, Field, FTLEPipeline, Grid
from lagrangiancoherence_tpu_torch.runners import ftle_series
from lagrangiancoherence_tpu_torch.testing import flows
from lagrangiancoherence_tpu_torch.utils import logging as L

torch.set_num_threads(1)

DT = -6 * 3600.0
TOOK = "%s took %.3f s"      # the message the benchmark's SpanLog parses
PIPELINE_STAGES = ("Prefilter", "SETTLS loop", "Gradient and norm")


class Records(logging.Handler):
    """Every record of the port's logger at ``level`` and above, with the
    logger set to ``level`` while the context is open."""

    def __init__(self, level=logging.INFO):
        super().__init__(level)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def spans(self):
        return [r for r in self.records if r.msg == TOOK]

    def names(self):
        return [r.args[0] for r in self.spans()]

    def __enter__(self):
        self._level = L.logger.level
        L.logger.setLevel(self.level)
        L.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        L.logger.removeHandler(self)
        L.logger.setLevel(self._level)


def _vortex(nt=3, d=8):
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL, dx=d, dy=d, nt=nt)
    u, v, lats, lons, times = flows.ideal_vortex(**cfg)
    return u, v, lats, lons, times


def _fields(nt, d=8):
    u, v, lats, lons, times = _vortex(nt, d)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return Field(u, dims, coords, name="u"), Field(v, dims, coords, name="v")


def test_record_is_what_spanlog_parses():
    """The exit record's ``msg`` and ``args`` are exactly
    ``"%s took %.3f s"`` and ``(name, seconds)``, after the banner, both at
    the span's level; a DEBUG span builds no record at INFO."""
    with Records() as rec:
        with L.timed_stage("Stage A"):
            pass
        with L.timed_stage("Stage B", logging.DEBUG):
            pass
    banner, took = rec.records
    assert (banner.msg, banner.args) == ("*---- %s ----*", ("Stage A",))
    assert took.msg == TOOK and len(took.args) == 2
    assert took.args[0] == "Stage A" and isinstance(took.args[1], float)
    assert 0.0 <= took.args[1] < 1.0
    assert took.levelno == banner.levelno == logging.INFO
    assert took.getMessage() == f"Stage A took {took.args[1]:.3f} s"
    with Records(logging.DEBUG) as rec:
        with L.timed_stage("Stage B", logging.DEBUG):
            pass
    assert [r.levelno for r in rec.records] == [logging.DEBUG] * 2
    assert rec.names() == ["Stage B"]


def test_ids_nest_and_pop_on_exception():
    """A span's ``parent_id`` is the enclosing span's ``span_id`` and its
    ``root_id`` the outermost's; a span left by an exception is popped, so
    the next span is a root again."""
    with Records() as rec:
        with L.timed_stage("root"):
            with L.timed_stage("child"):
                with L.timed_stage("grandchild"):
                    pass
            with pytest.raises(ValueError):
                with L.timed_stage("failing"):
                    raise ValueError("inside the span")
            with L.timed_stage("sibling"):
                pass
        with L.timed_stage("next root"):
            pass
    assert L._current.get() is None
    by = {r.args[0]: r for r in rec.spans()}
    root = by["root"]
    assert root.parent_id is None and root.root_id == root.span_id
    assert by["child"].parent_id == root.span_id
    assert by["grandchild"].parent_id == by["child"].span_id
    assert by["failing"].parent_id == root.span_id
    assert by["sibling"].parent_id == root.span_id
    for name in ("child", "grandchild", "failing", "sibling"):
        assert by[name].root_id == root.span_id
    nxt = by["next root"]
    assert nxt.parent_id is None and nxt.root_id == nxt.span_id
    ids = [r.span_id for r in rec.spans()]
    assert len(set(ids)) == len(ids)
    assert "span_id" not in rec.spans()[0].getMessage()


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running a span enters no ``record_function``; with
    one running it enters one range of its own name."""
    entered = []
    real = L._profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(L._profiler, "record_function", spy)
    with L.timed_stage("quiet"), L.timed_stage("inner", logging.DEBUG):
        torch.ones(4).sum()
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with L.timed_stage("traced", logging.DEBUG):
            torch.ones(4).sum()
    assert entered == ["traced"]


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def test_pipeline_stages_lie_inside_ftle_field_on_the_trace(tmp_path):
    """Under a CPU ``torch.profiler`` one field of a small ``FTLEPipeline``
    gives a ``user_annotation`` "FTLE field" that contains "Prefilter",
    "SETTLS loop" and "Gradient and norm", in that order, with the logger
    not enabled for their level."""
    u, v, lats, lons, _ = _vortex(nt=3)
    model = FTLEPipeline(Grid(lats=lats, lons=lons, cyclic_x=True),
                         settls_order=1, dtype=torch.float32, device="cpu")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(u, v, DT)
    ann = _annotations(prof, tmp_path)
    (field,) = [a for a in ann if a[0] == "FTLE field"]
    inside = [a for a in ann if a[0] in PIPELINE_STAGES]
    assert [a[0] for a in sorted(inside, key=lambda a: a[1])] \
        == list(PIPELINE_STAGES)
    for _, t0, t1 in inside:
        assert field[1] <= t0 <= t1 <= field[2]


def test_series_logs_each_stage_once():
    """One ``ftle_series`` call logs "Series record prep", "Series record
    upload" and "Series assembly" once each, and exactly one span whose
    name starts with "FTLE series: ", all under one root, "Series call";
    at DEBUG, one copy back a chunk and one "FTLE field" a window under
    it."""
    U, V = _fields(nt=5)
    with Records() as rec:
        out = ftle_series(U, V, DT, window=3, stride=1, settls_order=1,
                          batch=2, device="cpu")
    names = rec.names()
    assert out.shape[0] == 3
    for name in ("Series record prep", "Series record upload",
                 "Series assembly", "Series call"):
        assert names.count(name) == 1, names
    assert [n for n in names if n.startswith("FTLE series: ")] \
        == ["FTLE series: 3 windows"]
    assert not [n for n in names if n in PIPELINE_STAGES + ("FTLE field",)]
    (root,) = [r for r in rec.spans() if r.args[0] == "Series call"]
    assert root.parent_id is None
    assert {r.root_id for r in rec.spans()} == {root.span_id}
    with Records(logging.DEBUG) as rec:
        ftle_series(U, V, DT, window=3, stride=1, settls_order=1, batch=2,
                    device="cpu")
    names = rec.names()
    assert names.count("Series chunk copy back") == 2
    assert names.count("FTLE field") == 3
    assert names.count("Grid state") == 1
    (windows,) = [r for r in rec.spans()
                  if r.args[0].startswith("FTLE series: ")]
    for r in rec.spans():
        if r.args[0] in ("FTLE field", "Series chunk copy back"):
            assert r.parent_id == windows.span_id


def test_lcs_call_logs_its_root_once():
    """One ``LCS`` call logs "LCS call" once, as the root of every span of
    the call: the ordering (once: the propagation takes the ordered
    tensors), on the global path the regrid and the truncation, the
    propagation and the deformation."""
    U, V = _fields(nt=3)
    regional = ("Sort to ascending coordinates", "Parcel propagation",
                "Deformation tensor + eigenvalues")
    glob = regional + ("Regrid to common global grid",
                       "Spectral truncation T10")
    for call, stages in ((dict(), regional),
                         (dict(isglobal=True, truncation=10), glob)):
        with Records() as rec:
            LCS(timestep=DT, SETTLS_order=1, device="cpu")(
                u=U, v=V, verbose=False, **call)
        names = rec.names()
        assert sorted(names) == sorted(stages + ("LCS call",)), names
        (root,) = [r for r in rec.spans() if r.args[0] == "LCS call"]
        assert root.parent_id is None and names[-1] == "LCS call"
        assert {r.root_id for r in rec.spans()} == {root.span_id}
        assert {r.parent_id for r in rec.spans()} == {None, root.span_id}

"""Reading ``torch.profiler`` traces: device busy time, over all the cell's
cards and card by card, idle gaps labelled by what the host was doing,
device time by kernel, and device time of the kernels launched inside a
given Python function (from the profiler's Python stacks)."""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


def sync(devices: list) -> None:
    """Wait for every CUDA card of ``devices``, the cell's list: for a
    one-card cell, one ``torch.cuda.synchronize`` of that card."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def profile(fn, calls: int, devices: list, *, with_stack: bool = False,
            lead: int = 0, tries: int = 3) -> dict:
    """``torch.profiler`` over ``lead`` + ``calls`` calls of ``fn(i)``,
    each marked ``bench.call``, ended by a synchronise of every card of
    ``devices``; taken again, up to ``tries`` times, where it saw no device
    operation (the profiler drops events now and then).  The ``lead`` calls
    take the profiler's start-up and are not read by ``device_summary``.
    Returns the trace's events, the stretch's length by the host clock and
    ``lead``."""
    from torch.profiler import ProfilerActivity, profile as _profile
    cuda = any(d.type == "cuda" for d in devices)
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    for attempt in range(tries):
        sync(devices)
        with _profile(activities=acts, with_stack=with_stack) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.stretch"):
                for i in range(lead + calls):
                    with torch.profiler.record_function("bench.call"):
                        fn(i)
                sync(devices)
            wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        if dev or not cuda:
            break
        print(f"trace: the profiler saw no device operation "
              f"(try {attempt + 1} of {tries})", file=sys.stderr)
    return {"events": events, "wall_s": wall, "calls": calls, "lead": lead}


def _intervals(events, cats):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e) for e in events if e.get("cat") in cats and "ts" in e)


def _busy(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals sorted
    by start."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in intervals:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def device_summary(prof: dict) -> dict:
    """Over the traced window: busy seconds (the union of device
    operations on all cards), each card's busy seconds (``busy_s_per_card``,
    keyed by the card index a device operation carries, ``args.device``;
    one that carries none counts on card 0), the window's length, the
    device operations that took the most time, and the longest idle gaps of
    the union, each labelled by the innermost host event running at its
    middle (or the last one that ended before it).  All are read from the
    trace's own timestamps: the window runs from the start of the first
    call after the ``lead`` ones to the later of that call series' end and
    the last device operation's end, so the profiler's start-up and the
    host clock's reading take no part."""
    ev = prof["events"]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ev if e.get("name") == "bench.call"
                   and e.get("cat") == "user_annotation")
    dev = _intervals(ev, DEVICE_CATS)
    lead = prof.get("lead", 0)
    if len(calls) > lead:
        s0 = calls[lead][0]
        s1 = max([calls[-1][1]] + [t1 for _, t1, _ in dev])
    else:
        s0, s1 = 0.0, prof["wall_s"] * 1e6
    dev = [(max(t0, s0), min(t1, s1), e) for t0, t1, e in dev
           if t1 > s0 and t0 < s1]
    host = _intervals(ev, HOST_CATS)
    by_name: dict[str, float] = {}
    by_card: dict[int, list] = {}
    end, merged = float("-inf"), []
    for t0, t1, e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t1 - t0) * 1e-6
        by_card.setdefault(int(e.get("args", {}).get("device", 0)),
                           []).append((t0, t1))
        if t0 > end:
            merged.append([t0, t1])
        else:
            merged[-1][1] = max(merged[-1][1], t1)
        end = max(end, t1)
    gaps = []
    if merged:
        edges = [s0] + [x for iv in merged for x in iv] + [s1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    labelled = [((g1 - g0) * 1e-6, _label(host, (g0 + g1) / 2))
                for g0, g1 in longest]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": _busy((t0, t1) for t0, t1, _ in dev) * 1e-6,
            "busy_s_per_card": {k: _busy(v) * 1e-6
                                for k, v in sorted(by_card.items())},
            "window_s": (s1 - s0) * 1e-6,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[lab, s] for s, lab in labelled],
            "device_op_count": len(dev)}


def _label(host, t: float) -> str:
    inner, last = None, None
    for h0, h1, e in host:
        if h0 <= t <= h1 and e.get("name") not in ("bench.stretch",
                                                     "bench.call"):
            if inner is None or h1 - h0 <= inner[1] - inner[0]:
                inner = (h0, h1, e)
        elif h1 < t and (last is None or h1 > last[1]):
            last = (h0, h1, e)
    if inner is not None:
        return "host: " + inner[2]["name"]
    return "host after: " + last[2]["name"] if last else "host: none"


def device_time_in(prof: dict, functions) -> tuple[float, int] | None:
    """Seconds of device time, and the kernel count, of the kernels whose
    launch lies inside a call of one of ``functions`` by the profiler's
    Python stacks.  ``functions``: (path suffix, function name) pairs, e.g.
    ``("ops/interp.py", "prefilter")``.  A kernel whose launch the trace
    does not hold is placed at the launch before it (launches are numbered
    in host order).  None where no such call, or no kernel in one, was
    seen."""
    ev = prof["events"]
    spans = []
    for e in ev:
        if e.get("cat") != "python_function" or "ts" not in e:
            continue
        name = e.get("name", "")
        for path, func in functions:
            if name.endswith(f": {func}") and path in name.split("(")[0]:
                spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not spans:
        return None
    launches = sorted((int(e["args"]["correlation"]), float(e["ts"]))
                      for e in ev if e.get("cat") in LAUNCH_CATS
                      and "correlation" in e.get("args", {}))
    at = dict(launches)
    corr = [c for c, _ in launches]
    total, n = 0.0, 0
    for e in ev:
        if e.get("cat") != "kernel":
            continue
        c = int(e.get("args", {}).get("correlation", -1))
        t = at.get(c)
        if t is None:
            i = bisect.bisect_left(corr, c) - 1
            if i < 0:
                continue
            t = launches[i][1]
        if any(s0 <= t <= s1 for s0, s1 in spans):
            total += float(e["dur"]) * 1e-6
            n += 1
    return (total, n) if n else None


def categories(prof: dict) -> dict:
    """Event counts by category, and how many kernels have their launch in
    the trace: what a reader of the trace can rely on."""
    ev = prof["events"]
    cats: dict[str, int] = {}
    for e in ev:
        cats[e.get("cat", "?")] = cats.get(e.get("cat", "?"), 0) + 1
    corr = {int(e["args"]["correlation"]) for e in ev
            if e.get("cat") in LAUNCH_CATS
            and "correlation" in e.get("args", {})}
    kern = [e for e in ev if e.get("cat") == "kernel"]
    linked = sum(int(e.get("args", {}).get("correlation", -1)) in corr
                 for e in kern)
    return {"categories": cats, "kernels": len(kern),
            "kernels_with_launch": linked}

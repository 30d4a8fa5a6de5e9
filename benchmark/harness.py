"""The benchmark's machinery, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``, the deployment's
sizes) and a traffic mix (``traffic/<mix>.json``, whose ``entry`` names the
entry point ``entries/<entry>.py`` and whose other keys are that entry's
parameters).  Each metric is read by ``metrics/<metric>.py``, or where
there is no such file by ``metrics/<the metric's name up to its first
dot>.py`` (one reader for ``device_idle_pct.fields`` and
``device_idle_pct.facade``); a per-cell file ``limits/<cell>.json`` holds
the limit of every number that decides ``correct``, with the readings it
was set from.  So a later cell, mix, entry point, configuration or metric
is a new file and a new entry, and no file here changes.

A configuration may state ``"cards": n`` (1 where it does not), and each
cell that names it asks for as many ``chips``; the cell's cards are
``cuda:0`` to ``cuda:(n - 1)`` (``cards``).  The harness waits on, traces
and records every one of them.

One run: set up and warm up the cell (``setup_s`` runs from the start of
the process to the start of the window), call the entry point back to back
for ``seconds`` (a closed loop: one caller, each call after the last
returns), close the window with a synchronise, and keep a sample of the
answers drawn from the seed.  A traced run then reads the program's spans
(its ``timed_stage`` log records, seen during the window) and profiles a
short stretch of further calls.  Last, with the program's state freed, the
plain reference recomputes every sampled answer and the comparison decides
``correct``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import logging
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import trace as T

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lagrangiancoherence_tpu")
PROGRAM_LOGGER = "lagrangiancoherence_tpu_torch"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, manifest: dict | None = None) -> dict:
    """The cell ``name`` of the manifest: its entry, its configuration and
    traffic (parsed), its limits, and its metrics (entries)."""
    man = manifest or load_json(ROOT / "BENCHMARK.json")
    try:
        w = next(w for w in man["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    cfg = load_json(ROOT / conf["file"])
    if w["chips"] != cfg.get("cards", 1):
        raise SystemExit(f"workload {name!r} asks for {w['chips']} chip(s) "
                         f"but its configuration {conf['name']!r} states "
                         f"{cfg.get('cards', 1)} card(s)")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "entry": w, "config": cfg,
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json"),
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)]}


def entry(name: str):
    """The class ``Entry`` of ``entries/<name>.py``."""
    return importlib.import_module(f"benchmark.entries.{name}").Entry


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, else ``metrics/<metric up to its first
    dot>.py``: metrics that differ only in the cells they move share a
    reader."""
    path = HERE / "metrics" / f"{metric}.py"
    return path if path.is_file() else HERE / "metrics" / (
        metric.split(".")[0] + ".py")


def reader(metric: str):
    """The module that reads ``metric`` (names may hold dots)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cards(cfg: dict, device) -> list:
    """The cell's devices: the configuration's ``cards`` CUDA cards from
    ``device`` on (``cuda:0`` to ``cuda:(n - 1)`` from ``cuda:0``), or
    ``device`` as many times off the card.  An entry for several cards
    takes its devices from here."""
    n = cfg.get("cards", 1)
    if device.type != "cuda":
        return [device] * n
    return [torch.device("cuda", (device.index or 0) + i) for i in range(n)]


class Reservoir:
    """A uniform sample of ``k`` calls of all the window's calls, drawn
    from the seed (reservoir sampling): the entry's ``keep`` turns a
    chosen call's output into (key, answer) pairs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, out, keep) -> None:
        if len(self.items) < self.k:
            self.items.append(keep(i, out))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = keep(i, out)

    def answers(self) -> list:
        """The kept (key, answer) pairs, answers as host arrays."""
        return [(k, a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
                for item in self.items for k, a in item]


class SpanLog(logging.Handler):
    """The program's ``timed_stage`` records ("<stage> took %.3f s"): the
    stage's name and its raw seconds from ``record.args``."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.spans: list[tuple[str, float]] = []

    def emit(self, record):
        if record.msg == "%s took %.3f s" and len(record.args) == 2:
            self.spans.append((str(record.args[0]), float(record.args[1])))

    def __enter__(self):
        log = logging.getLogger(PROGRAM_LOGGER)
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger(PROGRAM_LOGGER)
        log.removeHandler(self)
        log.setLevel(self._level)


def window(drv, seconds: float, sample: Reservoir, devices: list) -> dict:
    """Calls back to back until ``seconds`` have passed at the end of a
    call, then a synchronise of every card of ``devices``, the cell's list:
    every call started is completed and counted."""
    T.sync(devices)
    call_s = []
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        out = drv.call(len(call_s))
        c1 = time.perf_counter()
        call_s.append(c1 - c0)
        sample.offer(len(call_s) - 1, out, drv.keep)
        if c1 - t0 >= seconds:
            break
    T.sync(devices)
    window_s = time.perf_counter() - t0
    return {"calls": len(call_s), "units": len(call_s) * drv.units_per_call,
            "window_s": window_s, "call_s": call_s}


class Run:
    """What the metric readers read: the window, the set-up, the spans and
    the traces of one run."""

    def __init__(self, **kw):
        self.spans, self.summary, self.stack = [], None, None
        self.__dict__.update(kw)


SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


def smi(device, fields) -> list[str]:
    """``nvidia-smi``'s readings of ``fields`` for the card, or [] where it
    cannot read them."""
    exe = shutil.which("nvidia-smi")
    if device.type != "cuda" or not exe:
        return []
    out = subprocess.run([exe, f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    lines = out.stdout.splitlines()
    i = device.index or 0
    return [x.strip() for x in lines[i].split(",")] if len(lines) > i else []


def set_tf32(cfg: dict) -> None:
    """TF32 for matmuls and convolutions as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])


def tf32_holds(cfg: dict) -> bool:
    return (torch.backends.cuda.matmul.allow_tf32 == bool(cfg["tf32"])
            and torch.backends.cudnn.allow_tf32 == bool(cfg["tf32"]))


def device_record(devs: list) -> dict:
    """The result line's ``device``: ``count`` the cell's cards,
    ``memory_peak_bytes`` the fullest card's peak and
    ``memory_peak_bytes_per_card`` each card's, in the cell's order."""
    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0, "memory_peak_bytes_per_card": []}
    peaks = [int(torch.cuda.max_memory_allocated(d)) for d in devs]
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]),
           "count": len(devs), "memory_peak_bytes": max(peaks),
           "memory_peak_bytes_per_card": peaks}
    limit = smi(devs[0], ("power.limit",))
    if limit:
        rec["power_limit"] = limit[0]
    return rec


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, c: dict | None = None, log=print) -> dict:
    """One run of cell ``name``; returns the result line's fields and the
    run's other numbers.  ``device``: the cell's first card (``cards``
    gives the rest); ``c``: the cell (``cell(name)`` by default; the tests
    pass a smaller one)."""
    c = c or cell(name)
    cfg, traffic = c["config"], c["traffic"]
    devs = cards(cfg, device)
    set_tf32(cfg)
    drv = entry(traffic["entry"])(cfg, traffic, seed, device)
    T.sync(devs)
    setup_s = time.perf_counter() - t_start
    sample = Reservoir(traffic["sample_calls"], seed)
    spans = SpanLog()
    card = [[smi(d, SMI_FIELDS) for d in devs]]
    if traced:
        with spans:
            win = window(drv, seconds, sample, devs)
    else:
        win = window(drv, seconds, sample, devs)
    card.append([smi(d, SMI_FIELDS) for d in devs])
    if not tf32_holds(cfg):
        raise RuntimeError(f"TF32 changed during the window; the "
                           f"configuration states tf32 = {cfg['tf32']}")
    run = Run(cfg=cfg, traffic=traffic, setup_s=setup_s, spans=spans.spans,
              units_per_call=drv.units_per_call, **win)
    log(f"window: {win['calls']} calls, {win['units']} units in "
        f"{win['window_s']:.4f} s; set-up {setup_s:.3f} s")
    for d, first, last in zip(devs, *card):
        if first:
            log(f"card {d.index} at the window's start and end "
                f"({', '.join(SMI_FIELDS)}): {first} {last}")
    if traced:
        base = win["calls"]
        run.summary = T.device_summary(T.profile(
            lambda i: drv.call(base + i), traffic["profile_calls"], devs,
            lead=1))
        needs = {n for m in c["per_layer"]
                 for n in getattr(reader(m["name"]), "NEEDS", ())}
        if "stack" in needs:
            run.stack = T.profile(lambda i: drv.call(base + i),
                                  traffic["stack_calls"], devs,
                                  with_stack=True)
            run.stack_units = traffic["stack_calls"] * drv.units_per_call
            log(f"stack trace: {json.dumps(T.categories(run.stack))}")
    metrics_list = c["per_layer"] if traced else c["end_to_end"]
    metrics = {}
    for m in metrics_list:
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_record(devs)
    answers = sample.answers()
    drv.release()
    del sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per, whole = drv.check(answers, device)
    checks, failed = judge(per, whole, c["limits"]["limits"])
    log(f"reference: {len(answers)} answers compared in "
        f"{time.perf_counter() - t0:.3f} s: {json.dumps(per)}")
    out = {"correct": all(ch["value"] <= ch["limit"]
                          for ch in checks.values()),
           "attempted": win["calls"], "failed": failed, "metrics": metrics,
           "device": dev}
    if traced:
        s = run.summary
        busy = [s["busy_s_per_card"].get(d.index, 0.0) for d in devs]
        # busy seconds averaged over the cell's cards: a card that idles
        # lowers it
        out["device"].update(busy_s=sum(busy) / len(devs),
                             window_s=s["window_s"],
                             busy_s_per_card=busy)
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    out["checks"] = checks
    return out


def judge(per: list[dict], whole: dict, limits: dict):
    """Each number compared, with its limit: a per-answer number as its
    worst over the sampled answers, and the whole window's counts; and the
    count of failed answers (a sampled answer over a limit, a call whose
    stamp or overflow word is wrong)."""
    names = [n for n in (per[0] if per else {}) if n in limits]
    checks = {n: {"value": max(p[n] for p in per), "limit": limits[n]}
              for n in names}
    checks.update({n: {"value": v, "limit": limits[n]}
                   for n, v in whole.items()})
    failed = sum(any(p[n] > limits[n] for n in names) for p in per)
    failed += sum(int(v) for n, v in whole.items() if v > limits[n])
    return checks, failed


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))

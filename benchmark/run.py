"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics come from ``BENCHMARK.json`` and the files under
``benchmark/``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error.  Without a CUDA card, or
with JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few host threads: the facade's host copies fault in
# fresh pages from every thread at once, and at 8 threads on the card's
# 8-core host their time drifts between runs (see PERF.md)
HOST_THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    torch.set_num_threads(HOST_THREADS)
    from benchmark import harness

    c = harness.cell(args.workload)
    chips = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START, c=c)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: modules loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    d = out["device"]
    print(f"device: {d['kind']}, power limit {d.get('power_limit', '?')}, "
          f"peak {d['memory_peak_bytes']} B")
    for k, m in out["metrics"].items():
        print(f"{k} = {m['value']!r} {m['unit']}")
    if "breakdown" in out:
        print(f"busy {d['busy_s']!r} s of {d['window_s']!r} s")
        for kind, rows in out["breakdown"].items():
            for name, s in rows:
                print(f"{kind}: {s!r} s  {name}")
    for k, ch in out["checks"].items():
        print(f"check {k} = {ch['value']!r} (limit {ch['limit']!r})",
              file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e] [--twin-seeds ...] [--seconds 2] \
        [--free-winds] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the comparison of its sampled answers with the plain
reference, as ``run.py`` makes them (the program's readings: the lower
ones).  For each control seed also the control, the reference computed in
float32 with every matmul in TF32 put in the program's place, on the same
inputs and the same sample (the upper readings); for each twin seed the
reference in float32 put there, which reads what float32 itself costs.
``--free-winds`` draws the winds' speeds and wavenumbers freely over the
mix's ranges (``winds.py``), not from the fixed set the timed cells use.
One JSON line a seed on standard output, and in ``--out``.  The
benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(per: list, whole: dict) -> dict:
    out = {n: max(p[n] for p in per) for n in (per[0] if per else {})}
    out.update(whole)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--twin-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--free-winds", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = harness.cell(args.workload)
    cfg, traffic = c["config"], c["traffic"]
    if args.free_winds:
        traffic = {**traffic, "winds": {**traffic["winds"], "free": True}}
    harness.set_tf32(cfg)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    twin = {int(s) for s in args.twin_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for seed in seeds + sorted((control | twin) - set(seeds)):
        t0 = time.perf_counter()
        drv = harness.entry(traffic["entry"])(cfg, traffic, seed, device)
        sample = harness.Reservoir(traffic["sample_calls"], seed)
        win = harness.window(drv, args.seconds, sample,
                             harness.cards(cfg, device))
        answers = sample.answers()
        drv.release()
        del sample
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed,
               "free_winds": args.free_winds,
               "calls": win["calls"], "answers": [k for k, _ in answers]}
        if seed in seeds:
            rec["program"] = readings(*drv.check(answers, device))
        t2 = time.perf_counter()
        if seed in control:
            rec["control"] = readings(*drv.check(answers, device, "control"))
        if seed in twin:
            rec["float32"] = readings(*drv.check(answers, device, "float32"))
        rec["seconds"] = {"setup_window": t1 - t0, "reference": t2 - t1,
                          "control": time.perf_counter() - t2}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del drv
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

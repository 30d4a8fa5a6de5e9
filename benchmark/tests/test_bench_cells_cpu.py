"""Every cell end to end on the CPU at a small size: set-up, window,
sample, the traced stretch, the reference, and a result line in the
shape ``run.py`` prints; and no loaded module of JAX or the JAX package."""
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from _small import CELLS, SEED, small

MAN = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_cpu(name, traced):
    c = small(name)
    out = harness.run_cell(name, SEED, 0.2, traced, torch.device("cpu"),
                           time.perf_counter(), c=c, log=lambda *a: None)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for k, ch in line["checks"].items():
        assert ch["value"] <= ch["limit"], k
    want = c["per_layer"] if traced else c["end_to_end"]
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    if not traced:
        # every end-to-end metric is read on the CPU too (host clock)
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device trace on the CPU: the device's readers stay silent
        assert not any(n.startswith(("device_idle", "prefilter_r",
                                     "settls_loop_r", "ftle_r"))
                       for n in line["metrics"])


def test_no_jax_loaded():
    """The harness, its reference and the port's entry points load no
    module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
    ``lagrangiancoherence_tpu`` (whole names: the port's name begins with
    the JAX package's)."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness as h, benchmark.calibrate;"
            "[h.entry(e) for e in ('pipeline', 'series', 'facade')];"
            "import lagrangiancoherence_tpu_torch.api, "
            "lagrangiancoherence_tpu_torch.runners, "
            "lagrangiancoherence_tpu_torch.models.pipeline;"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole():
    sys.modules.setdefault("lagrangiancoherence_tpu_torch_x", sys)
    try:
        assert "lagrangiancoherence_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["lagrangiancoherence_tpu_torch_x"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.ftle, benchmark.reference.facade;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lagrangiancoherence_tpu_torch', 'lagrangiancoherence_tpu', "
            "'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "global-resident", "--seed", "5", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


VARIANTS = {
    # a mix or a configuration that later cells can add as data alone
    "ftle_pipeline": ("global-resident", "traffic", {"call": "ftle_pipeline"}),
    "resample12h": ("cli-t20", "config", {"resample": "12h"}),
    "no_truncation": ("cli-t20", "config", {"truncation": None}),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_runs_on_cpu(variant):
    name, part, keys = VARIANTS[variant]
    c = small(name)
    c[part].update(keys)
    if variant == "resample12h":
        c["config"]["levels"] = 5
    out = harness.run_cell(name, SEED, 0.2, False, torch.device("cpu"),
                           time.perf_counter(), c=c, log=lambda *a: None)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in c["end_to_end"]}

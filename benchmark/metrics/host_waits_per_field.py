"""Host waits on the card a field: the CUDA runtime calls that block the
host until the card has caught up (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the blocking
``cudaMemcpy``), counted where they start inside the program's span "FTLE
field" (``FTLEPipeline.forward``) in the stack-traced stretch, over its
fields.  None where the trace holds no such span or no device operation
(a run without a card)."""
from benchmark import trace

NEEDS = ("stack",)
SPAN = "FTLE field"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def count(events) -> int | None:
    """Waits that start inside a "FTLE field" span; None without one."""
    fields = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == SPAN]
    if not fields:
        return None
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and e.get("name") in WAITS
               and any(t0 <= float(e["ts"]) <= t1 for t0, t1 in fields))


def read(run):
    ev = run.stack["events"]
    if not any(e.get("cat") in trace.DEVICE_CATS for e in ev):
        return None
    n = count(ev)
    return None if n is None else n / run.stack_units

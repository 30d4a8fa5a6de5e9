"""Host waits on the card a case inside ``skeletonize``: the CUDA runtime
calls that block the host until the card has caught up
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the blocking ``cudaMemcpy``), counted where
they start inside the program's span "Skeletonize" in the stack-traced
stretch, over its cases (as ``host_waits_per_field`` counts them in "FTLE
field").  None where the trace holds no such span or no device operation
(a run without a card)."""
from benchmark import spans, trace

NEEDS = ("stack",)
SPAN = "Skeletonize"


def read(run):
    ev = run.stack["events"]
    if not any(e.get("cat") in trace.DEVICE_CATS for e in ev):
        return None
    n = spans.waits_inside(ev, SPAN)
    return None if n is None else n / run.stack_units

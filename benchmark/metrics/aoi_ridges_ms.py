"""The program's "Hessian ridges" span of each "AOI case" (the smoothed
Hessian, its eigen-quantities and the masks, with the copies to the host),
median over a traced run's cases, in milliseconds."""
from benchmark import spans

ROOT = "AOI case"
SPANS = ("Hessian ridges",)


def read(run):
    return spans.median_ms(run.spans, ROOT, SPANS)

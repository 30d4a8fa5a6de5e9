"""The program's "Skeletonize" span of each "AOI case" (the Zhang-Suen
sweeps and their host checks), median over a traced run's cases, in
milliseconds."""
from benchmark import spans

ROOT = "AOI case"
SPANS = ("Skeletonize",)


def read(run):
    return spans.median_ms(run.spans, ROOT, SPANS)

"""The program's two "LCS call" spans of each "AOI case" (the window's FTLE
and the local FTLE), summed, median over a traced run's cases, in
milliseconds."""
from benchmark import spans

ROOT = "AOI case"
SPANS = ("LCS call",)


def read(run):
    return spans.median_ms(run.spans, ROOT, SPANS)

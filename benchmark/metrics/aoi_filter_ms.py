"""The program's "Ridge filter" spans of each "AOI case" (both calls of
``filter_ridges``: the FTLE criteria and the pressure gradient), summed,
median over a traced run's cases, in milliseconds."""
from benchmark import spans

ROOT = "AOI case"
SPANS = ("Ridge filter",)


def read(run):
    return spans.median_ms(run.spans, ROOT, SPANS)

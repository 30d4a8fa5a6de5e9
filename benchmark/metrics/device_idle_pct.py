"""Share of the traced window in which no operation ran on the card
(kernels, copies and sets), by the trace's own timestamps: from the start
of the first call read to the end of the last call or the last device
operation, whichever is later.  One reader for every cell's form:
``device_idle_pct.fields`` (whole-field calls), ``device_idle_pct.series``
(series calls) and ``device_idle_pct.facade`` (facade calls)."""


def read(run):
    s = run.summary
    if s is None or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

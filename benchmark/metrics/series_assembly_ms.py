"""The program's "Series assembly" span (the series' host work after its
windows: the stamps, the fields concatenated into one array and the
``Field``), summed over a traced run's window and divided by its calls, in
milliseconds a call."""

SPAN = "Series assembly"


def read(run):
    s = [sec for name, sec in run.spans if name == SPAN]
    return sum(s) * 1e3 / run.calls if s else None

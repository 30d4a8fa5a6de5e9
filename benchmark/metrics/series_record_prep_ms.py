"""The program's "Series record prep" span (the series' host prep of its
record: sorted to ascending coordinates, transposed, and its grid), summed
over a traced run's window and divided by its calls, in milliseconds a
call."""

SPAN = "Series record prep"


def read(run):
    s = [sec for name, sec in run.spans if name == SPAN]
    return sum(s) * 1e3 / run.calls if s else None

"""The program's "Sort to ascending coordinates" spans (each host sort of
a record to ascending latitude and longitude: both wind components in
``LCS.__call__``, again in ``parcel_propagation``), summed over a traced
run's window and divided by its calls, in milliseconds a call."""

SPAN = "Sort to ascending coordinates"


def read(run):
    s = [sec for name, sec in run.spans if name == SPAN]
    return sum(s) * 1e3 / run.calls if s else None

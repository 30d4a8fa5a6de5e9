"""Milliseconds a window of a series call spends outside the program's
"FTLE series: N windows" span: the record's host prep and upload and the
stamping, summed over the window's calls of a traced run, over the windows
they completed."""

PREFIX = "FTLE series: "


def read(run):
    spans = [sec for name, sec in run.spans if name.startswith(PREFIX)]
    if len(spans) != run.calls:
        return None
    return (sum(run.call_s) - sum(spans)) * 1e3 / run.units

"""FTLE fields completed in the window over the window's seconds, up to its
closing synchronise (a series call completes one field a window).  Reads
``fields_per_s`` and each form of it kept apart for a cell of its own,
such as ``fields_per_s.series``, whose runs spread otherwise."""


def read(run):
    return run.units / run.window_s

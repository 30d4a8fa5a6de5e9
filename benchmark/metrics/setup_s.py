"""Set-up seconds: from the start of the process (before ``torch`` is
imported) to the start of the window: imports, the card's context, the
inputs, the program's state, kernel builds or loads, the warm-up calls."""


def read(run):
    return run.setup_s

"""Stage-granular logging and the port's spans, mirroring the reference's
``verboseprint`` convention (LagrangianCoherence LCS/LCS.py:72-75,
trajectory.py:47).

Counterpart of ``lagrangiancoherence_tpu/utils/logging.py`` under the port's
own logger name: each pipeline stage logs through the
``lagrangiancoherence_tpu_torch`` logger, and the ``verbose=`` API flag
toggles a stream handler at INFO level.

``timed_stage`` is the port's one span.  It times its block by the host
clock and logs ``"%s took %.3f s"`` with ``(name, seconds)`` as the
record's args; while a ``torch.profiler`` runs it also opens a
``record_function`` range of the same name, so the span lies in the
profiler's trace on the device operations' timebase.  Spans nest: each
record carries ``span_id``, ``parent_id`` and ``root_id`` as attributes
(``extra=``), and a root span (one ``LCS`` call, one series call, one
pipeline field) gives every span under it its ``root_id``.
"""
from __future__ import annotations

import contextvars
import itertools
import logging
import sys
from time import perf_counter

from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _profiler

LOGGER_NAME = "lagrangiancoherence_tpu_torch"

logger = logging.getLogger(LOGGER_NAME)

# (span_id, root_id) of the innermost open span, per thread and task
_current: contextvars.ContextVar[tuple[int, int] | None] = \
    contextvars.ContextVar("lagrangiancoherence_span", default=None)
_ids = itertools.count(1)


def configure_verbosity(verbose: bool) -> None:
    """Attach (or detach) a stderr INFO handler, idempotently."""
    existing = [h for h in logger.handlers if getattr(h, "_lcs_default", False)]
    if verbose and not existing:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        h._lcs_default = True
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    elif not verbose:
        for h in existing:
            logger.removeHandler(h)


def stage(msg: str, level: int = logging.INFO) -> None:
    """Stage banner, as the reference's ``*---- Parcel propagation ----*``
    prints (LagrangianCoherence LCS/LCS.py:127,140,151,156)."""
    logger.log(level, "*---- %s ----*", msg)


def timed_stage(name: str, level: int = logging.INFO) -> "_Span":
    """``with timed_stage(name, level=logging.INFO):`` — the span.

    With the logger enabled for ``level``, a banner on entry and
    ``"%s took %.3f s"`` (``name``, seconds by the host clock) on exit,
    both at ``level``; the exit record carries ``span_id``, ``parent_id``
    (None at a root) and ``root_id``.  With a profiler running, a
    ``record_function(name)`` range around the block; without one, none.
    The port's stages end with a copy to the host, so the host clock
    covers their device work.  A span is closed before any ``yield`` of
    the code inside it.
    """
    return _Span(name, level)


class _Span:
    __slots__ = ("name", "level", "_log", "_parent", "_id", "_root",
                 "_range", "_t0")

    def __init__(self, name: str, level: int):
        self.name, self.level = name, level

    def __enter__(self):
        self._log = logger.isEnabledFor(self.level)
        if self._log:
            stage(self.name, self.level)
        parent = self._parent = _current.get()
        sid = self._id = next(_ids)
        self._root = sid if parent is None else parent[1]
        _current.set((sid, self._root))
        self._range = None
        if _profiler_enabled():
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        parent = self._parent
        _current.set(parent)
        if self._log:
            logger.log(self.level, "%s took %.3f s", self.name, seconds,
                       extra={"span_id": self._id,
                              "parent_id": None if parent is None
                              else parent[0],
                              "root_id": self._root})
        return False

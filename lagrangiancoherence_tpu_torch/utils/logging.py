"""Stage-granular logging, mirroring the reference's ``verboseprint``
convention (LagrangianCoherence LCS/LCS.py:72-75, trajectory.py:47).

Counterpart of ``lagrangiancoherence_tpu/utils/logging.py`` under the port's
own logger name: each pipeline stage logs through the
``lagrangiancoherence_tpu_torch`` logger, and the ``verbose=`` API flag
toggles a stream handler at INFO level.
"""
from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager

LOGGER_NAME = "lagrangiancoherence_tpu_torch"

logger = logging.getLogger(LOGGER_NAME)


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


def stage(msg: str) -> None:
    """Stage banner, as the reference's ``*---- Parcel propagation ----*``
    prints (LagrangianCoherence LCS/LCS.py:127,140,151,156)."""
    logger.info("*---- %s ----*", msg)


@contextmanager
def timed_stage(msg: str):
    """Stage banner plus wall-clock timing.  The port's stages end with a
    copy to the host, so the host clock covers their device work."""
    stage(msg)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s took %.3f s", msg, time.perf_counter() - t0)

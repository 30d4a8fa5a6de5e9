"""What the readers of a case's spans share: the program's ``timed_stage``
records grouped by the root span they closed under, and the host's waits on
the card inside a span of the stack trace."""
from __future__ import annotations

import numpy as np

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def by_root(spans, root: str) -> list[list[tuple[str, float]]]:
    """The window's spans, a list for each ``root`` span: a span's record
    is written when it closes, so the spans of one root are those written
    after the previous ``root`` record, the root's own last."""
    groups, cur = [], []
    for name, sec in spans:
        cur.append((name, sec))
        if name == root:
            groups.append(cur)
            cur = []
    return groups


def median_ms(spans, root: str, names) -> float | None:
    """The median over the ``root`` spans of the seconds of the spans named
    in ``names`` under each, summed, in milliseconds; None without a
    ``root`` span or with none of ``names`` under any."""
    groups = by_root(spans, root)
    sums = [sum(s for n, s in g if n in names) for g in groups]
    if not groups or not any(n in names for g in groups for n, _ in g):
        return None
    return float(np.median(sums) * 1e3)


def waits_inside(events, span: str) -> int | None:
    """The blocking runtime calls (``WAITS``) that start inside a
    ``user_annotation`` range named ``span``; None without one."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == span]
    if not ranges:
        return None
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and e.get("name") in WAITS
               and any(t0 <= float(e["ts"]) <= t1 for t0, t1 in ranges))

"""A kernel's share of its roofline over the traced window.

Σ over its launches of the least time the card could take (``peaks``:
operations at the bf16 peak or bytes at HBM's, whichever is longer),
over Σ of their measured device time.  The launches' operations and
bytes come from ``costs/<kernel>.py`` at the shapes the traced engine
calls had.  Where the trace holds another number of launches than those
calls make, the counts do not describe what ran: the share is left out
and both numbers go into the run's notes.
"""

from __future__ import annotations

from typing import Optional

from . import manifest, peaks


def share(ctx, kernel: str) -> Optional[float]:
    trace = ctx.trace
    if trace is None or not trace.calls:
        return None
    cost = manifest.cost(kernel, ctx.base)
    measured = trace.matching(cost.MATCH)
    if not measured:
        return None
    per_call = cost.launches(ctx.cfg, trace.frames // trace.calls)
    if len(measured) != len(per_call) * trace.calls:
        ctx.notes[kernel] = {"launches_traced": len(measured),
                             "launches_counted": len(per_call) * trace.calls}
        return None
    least = trace.calls * sum(peaks.least_seconds(f, b) for f, b in per_call)
    ctx.notes[kernel] = {"bound": peaks.bound(*map(sum, zip(*per_call)))}
    return 100.0 * least / (sum(measured) / 1e6)

"""The comparison that decides ``correct``: each reading beside its limit.

The readings come from the reference's problem (``fem.Problem``: the
program's mesh against the reference's own) and from the request's judge
(``requests/<request>.py``: the kept answers against the reference's
operator).  Every reading passes when it is at most its limit.
"""

from __future__ import annotations

import math


def decide(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": reading, "limit": limit}}) over the names in
    ``limits``; a reading that is missing or not finite fails."""
    compared, ok = {}, True
    for name, lim in limits.items():
        value = readings.get(name, math.nan)
        limit = lim["limit"] if isinstance(lim, dict) else lim
        compared[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, compared

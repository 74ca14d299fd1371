"""The numbers that decide `correct`, each beside its limit.

Every number compared is a gap between the program's output and the plain
reference's (lower is closer), and passes when it is finite and at most its
limit.  The limits sit in the cell's workload file, under `limits`, each set
from the readings that `PERF.md` gives for it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def compare(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One `Check` per limit; a number the run could not produce reads
    infinite, and fails."""
    return [Check(k, float(values.get(k, math.inf)), float(v)) for k, v in limits.items()]


def passed(checks: List[Check]) -> bool:
    return bool(checks) and all(c.ok for c in checks)


def as_json(checks: List[Check]) -> Dict[str, dict]:
    return {c.name: {"value": c.value if math.isfinite(c.value) else None,
                     "limit": c.limit} for c in checks}


def lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name} = {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in checks]

"""Wall-clock section timing, analog of dealii::TimerOutput as used by
Hierarchy (reference common/hierarchy.hpp:36-47) and the driver
(tests/hierarchy_driver.cc:38-40).  A copy of mfmg_tpu/utils/timer.py; each
section is also a span of its name (utils/trace.py) while tracing is on."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

from mfmg_torch.utils.trace import span


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["+---------------------------------+------------+-------+",
                 "| Section                         | wall time  | calls |",
                 "+---------------------------------+------------+-------+"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"| {name:<31} | {self.totals[name]:>9.3f}s | {self.counts[name]:>5} |")
        lines.append(lines[0])
        return "\n".join(lines)

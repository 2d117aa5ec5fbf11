"""The reduction of a torch.profiler trace to the device's numbers.

Device busy time is the union of the device records' intervals, set beside
the CUDA-event wall of the same window (torch.profiler has dropped device
records on this card: a reader that needs every record of a kind counts
them).  The breakdown lists the device operations that took most time and
the idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclass
class Trace:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]  # device seconds by record name
    kernel_count: Dict[str, int]  # device records by name
    device_records: int
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def coverage(self) -> float:
        return self.busy_s / self.window_s if self.window_s > 0 else 0.0

    def seconds_matching(self, key: str) -> float:
        return sum(v for k, v in self.kernel_s.items() if key in k)

    def device_ops(self) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]


def reduce(events, window_s: float) -> Trace:
    """``events``: a profiler's events() (host and device records);
    window_s: the CUDA-event wall of the traced window."""
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if str(e.device_type).endswith("CUDA"):
            dev.append((s, t, e.name))
        elif t > s:
            host.append((s, t, e.name))
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_count: Dict[str, int] = defaultdict(int)
    for s, t, name in dev:
        kernel_s[name] += (t - s) * 1e-6
        kernel_count[name] += 1
    busy = union([(s, t) for s, t, _ in dev])
    tr = Trace(sum(t - s for s, t in busy) * 1e-6, window_s, dict(kernel_s), dict(kernel_count),
               len(dev))
    # the gaps between busy intervals, named by the innermost host record
    # that spans each gap's middle
    host.sort()
    starts = [s for s, _, _ in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid)
        name = "host idle"
        for s, t, n in reversed(host[max(0, i - 4000):i]):
            if t >= mid:
                name = n
                break
        gaps[name] += (s1 - e0) * 1e-6
    tr.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return tr

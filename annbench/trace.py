"""What a traced window shows: device operations, busy time, idle gaps
and what the host was doing in them, read from a torch.profiler session.

The harness opens the session on the thread that calls the search and
marks every search call with a span (`SPAN`); the window is the stretch
from the first to the last whole call the session saw, so the device time
and the queries counted belong to the same calls.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

SPAN = "annbench::search"
HOP, LUT, RERANK = "hop_kernel", "pq_lut_kernel", "rerank_kernel"
MICRO_GAP_S = 20e-6


@dataclass
class Window:
    """Device operations (name, start s, end s) clipped to the window, the
    window's bounds (s, the profiler's clock) and the host's operations."""
    lo: float
    hi: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy(self) -> list:
        """The union of the device operations' intervals, merged."""
        out = []
        for a, b in sorted((a, b) for _, a, b in self.device):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def op_seconds(self, part: str | None = None) -> float:
        """Summed device time of the ops whose name holds `part` (all ops
        for None)."""
        return sum(b - a for n, a, b in self.device
                   if part is None or part in n)

    def count(self, part: str) -> int:
        return sum(part in n for n, _, _ in self.device)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, a, b in self.device:
            by[name[:120]] += b - a
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time by what the host was doing: each gap between
        busy stretches is named after the shortest host operation that
        spans its midpoint ("no host op" where none does), and the gaps'
        seconds are summed by name. Gaps under `MICRO_GAP_S` (the card's
        own step from one kernel of a graph to the next) are summed
        apart."""
        edges = [self.lo] + [x for ab in self.busy() for x in ab] + [self.hi]
        by = defaultdict(float)
        host = sorted(self.host, key=lambda r: r[2] - r[1])
        starts = np.array([s for _, s, _ in host])
        ends = np.array([e for _, _, e in host])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < MICRO_GAP_S:
                by["between two device ops (< 20 us)"] += b - a
                continue
            mid = 0.5 * (a + b)
            hit = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = host[hit[0]][0] if len(hit) else "no host op"
            by[name[:120]] += b - a
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]


def read_window(prof) -> Window | None:
    """The window of a stopped profiler session: from the first to the
    last `SPAN` it recorded. None when it recorded no span."""
    from torch.autograd import DeviceType
    device, host, spans = [], [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name == SPAN:
            # the span's own device-side annotation is not an operation
            if e.device_type != DeviceType.CUDA:
                spans.append((a, b))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    if not spans:
        return None
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    w = Window(lo=lo, hi=hi)
    w.device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
                if b > lo and a < hi]
    w.host = [(SPAN, a, b) for a, b in spans] + \
        [(n, a, b) for n, a, b in host if b > lo and a < hi]
    return w

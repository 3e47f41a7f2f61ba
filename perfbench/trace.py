"""Reading a ``torch.profiler`` capture of the training loop: the device's
activity (kernels, copies, fills), the kernels by name, and the idle
gaps named by the benchmark span the host was in."""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "perfbench:"


class Capture:
    """The reduced trace: ``window_s`` (the host spans' extent), device
    intervals merged (``busy``), ``ops`` (device seconds and events by
    name) and the spans."""

    def __init__(self, events: List[dict]) -> None:
        spans = [(e["name"][len(SPAN_PREFIX):], e["ts"], e["ts"] + e["dur"])
                 for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        dev = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?")) for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.spans = sorted(spans, key=lambda s: s[1])
        self.w0 = min((s[1] for s in spans), default=0.0)
        self.w1 = max((s[2] for s in spans), default=0.0)
        self.window_s = (self.w1 - self.w0) * 1e-6
        self.ops: Dict[str, List[float]] = {}
        inside = []
        for a, b, name in dev:
            a, b = max(a, self.w0), min(b, self.w1)
            if b <= a:
                continue
            inside.append((a, b))
            rec = self.ops.setdefault(name, [0.0, 0])
            rec[0] += (b - a) * 1e-6
            rec[1] += 1
        self.busy = merge(inside)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def kernel(self, parts: Tuple[str, ...]):
        """(seconds of all the parts' events, events of the first part)
        for a kernel whose launch runs the device kernels ``parts``
        (substrings of their mangled names)."""
        secs = sum(t for name, (t, _) in self.ops.items() if any(p in name for p in parts))
        events = sum(n for name, (_, n) in self.ops.items() if parts[0] in name)
        return secs, events

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the device in the window, named by the
        benchmark span whose time holds its middle (``host`` where none)."""
        edges = [self.w0] + [x for ab in self.busy for x in ab] + [self.w1]
        starts = [s[1] for s in self.spans]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            # spans nest at most two deep (a reopen inside a next): the
            # innermost holding the middle is one of the last two begun
            held = [s[0] for s in self.spans[max(i - 1, 0):i + 1][::-1] if s[1] <= mid <= s[2]]
            out.append((held[0] if held else "host", (b - a) * 1e-6))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        by the span the host was in, then the longest single gaps."""
        ops = sorted(((name[:120], t) for name, (t, _) in self.ops.items()),
                     key=lambda x: -x[1])[:10]
        gaps = self.gaps()
        total: Dict[str, float] = {}
        for name, t in gaps:
            total[name] = total.get(name, 0.0) + t
        idle = [[f"all in {name}", t] for name, t in sorted(total.items(), key=lambda x: -x[1])]
        longest = [[f"longest in {name}", t] for name, t in sorted(gaps, key=lambda x: -x[1])]
        return {"device_ops": [list(o) for o in ops], "idle_gaps": (idle + longest)[:10]}


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def load(prof, directory: str) -> Capture:
    """Export ``prof``'s Chrome trace into ``directory``, reduce it and
    delete the file."""
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Capture(events)

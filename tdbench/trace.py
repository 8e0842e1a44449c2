"""Reading a ``torch.profiler`` Chrome trace of the traced slice.

``busy_us`` is a frozen copy of the union arithmetic of the program's
``utils/profiling.device_busy_us`` (kernel, copy and memset intervals), so
that the yardstick does not move with the program. Only events inside the
``tdbench.slice`` range count: the calls before it (one untraced, one
traced) let the profiler settle, since a trace can lose the first kernel
after the profiler starts.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass

SLICE = "tdbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# NVIDIA's published H100 SXM memory rate, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Slice:
    """What the traced slice holds, and the work of its calls."""
    start_us: float
    end_us: float
    device: list[tuple[float, float, str, str]]  # (start, end, cat, name)
    host: list[tuple[float, float, str]]         # (start, end, name)
    bytes: int = 0        # UTF-8 bytes of the slice's inputs
    chars: int = 0        # their characters
    ids: int = 0          # ids the slice's calls returned

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def busy_us(self) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in sorted((a, b) for a, b, _, _ in self.device):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def kernel_us(self, pattern: str | None = None) -> float:
        """Summed duration of the kernels (all, or those whose name
        matches ``pattern`` as a search)."""
        pat = re.compile(pattern) if pattern else None
        return sum(b - a for a, b, cat, name in self.device
                   if cat == "kernel" and (pat is None or pat.search(name)))

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(float)
        for a, b, _, name in self.device:
            by[short_name(name)] += b - a
        return [[n, s * 1e-6] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time grouped by what the host was doing: each gap
        between busy intervals is named by the innermost host event that
        covers its middle ("host: untraced" where none does), and the
        names are summed: [name, seconds], longest first."""
        spans = sorted((a, b) for a, b, _, _ in self.device)
        gaps, t = [], self.start_us
        for a, b in spans:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        by = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, name) for s, e, name in self.host
                     if s <= mid <= e]
            by[min(inner)[1] if inner else "host: untraced"] += b - a
        return [[n, s * 1e-6] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's demangled name without its namespace noise, return type
    and argument list; copies and memsets keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:120]


def read_slice(events: list[dict]) -> Slice | None:
    """The slice's events from a Chrome trace's ``traceEvents``; None when
    the trace holds no slice range."""
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e.get("name") == SLICE]
    if not ranges:
        return None
    s0 = float(ranges[0]["ts"])
    s1 = s0 + float(ranges[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b < s0 or a > s1:
            continue
        a, b = max(a, s0), min(b, s1)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append((a, b, cat, e.get("name", "")))
        elif cat in HOST_CATS and e.get("name") != SLICE:
            host.append((a, b, e.get("name", "")))
    return Slice(s0, s1, device, host)

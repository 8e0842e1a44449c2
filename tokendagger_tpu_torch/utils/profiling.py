"""Tracing and profiling helpers.

* ``profile_trace(dir)``: a ``torch.profiler`` trace of host and (with a
  card) CUDA activity, written to ``dir`` as a Chrome/Perfetto trace.
* ``device_busy_us(dir)``: the device's busy time in such a trace, from
  which a caller derives the device's idle share of a wall interval.
* ``stage_device_us(events, stages)``: the device time each
  ``torch.profiler.record_function`` range launched, and
  ``kernel_counts(events, names)`` the trace's kernel events by name.
* ``Timer``: nestable wall-clock section timer with a report.
* ``RateMeter``: bytes/tokens throughput accounting; its JSON schema is
  the JAX package's (``tokendagger_tpu/utils/profiling.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``log_dir`` (one ``*.pt.trace.json`` per
    trace); CUDA kernels are traced when a card is present. Yields the
    profiler, whose ``key_averages()`` sums time by operator and
    kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=handler) as prof:
        yield prof


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def trace_events(log_dir: str) -> list[dict]:
    """The events of the newest trace in ``log_dir`` ([] if none)."""
    paths = sorted(Path(log_dir).glob("*.pt.trace.json"),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        return []
    return json.loads(paths[-1].read_text()).get("traceEvents", [])


def device_busy_us(log_dir: str) -> tuple[float, int]:
    """Busy time of the device in the newest trace of ``log_dir``: the
    union of its kernel, copy and memset intervals in µs, and its number
    of kernels. (0.0, 0) when the trace holds no device activity."""
    events = trace_events(log_dir)
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, sum(e["cat"] == "kernel" for e in dev)


def _launch_stage(events: list[dict], stages) -> tuple[dict, set]:
    """correlation id -> the name of the ``record_function`` range (one
    of ``stages``) that holds the runtime call with that id on its
    thread; and the names of all such ranges in the trace."""
    ranges: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in stages):
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    for rs in ranges.values():
        rs.sort()
    stage_of: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        rs = ranges.get((e["pid"], e["tid"]))
        if corr is None or not rs:
            continue
        i = bisect.bisect_right(rs, (e["ts"], float("inf"), "")) - 1
        if i >= 0 and e["ts"] <= rs[i][1]:
            stage_of[corr] = rs[i][2]
    return stage_of, {r[2] for rs in ranges.values() for r in rs}


def stage_device_us(events: list[dict], stages) -> dict[str, float]:
    """µs of device work per ``record_function`` range named in
    ``stages``: the summed durations of the kernel, copy and memset events
    that the range launched. A device event is not inside its CPU range
    in time; it carries the ``args.correlation`` of the runtime call that
    launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync`` and kin), and
    that call lies inside the range on the launching thread. Summing the
    ranges' ``gpu_user_annotation`` spans instead would count the gaps
    between kernels. Ranges on one thread must not overlap; a range that
    launched no device work reports 0."""
    stage_of, seen = _launch_stage(events, stages)
    out = dict.fromkeys(sorted(seen), 0.0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            name = stage_of.get(e.get("args", {}).get("correlation"))
            if name is not None:
                out[name] += float(e["dur"])
    return out


def kernel_counts(events: list[dict], names, stages=None) -> dict[str, int]:
    """Kernel events of each function name in ``names``, matched as a
    whole identifier in the demangled kernel name; with ``stages``, only
    those launched inside a ``record_function`` range of those names."""
    pats = {n: re.compile(rf"(?<!\w){re.escape(n)}(?!\w)") for n in names}
    stage_of = _launch_stage(events, stages)[0] if stages else None
    out = dict.fromkeys(names, 0)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        if (stage_of is not None
                and e.get("args", {}).get("correlation") not in stage_of):
            continue
        for n, pat in pats.items():
            if pat.search(e.get("name", "")):
                out[n] += 1
    return out


class Timer:
    """Nestable section timer: ``with timer("scan"): ...``; ``report()``."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24} total {total * 1e3:9.1f} ms  "
                f"n={n:<6} avg {total / n * 1e6:9.1f} µs"
            )
        return "\n".join(lines)


class RateMeter:
    """Throughput accounting with the JAX package's JSON output."""

    def __init__(self, tokenizer_type: str = "llama") -> None:
        self.tokenizer_type = tokenizer_type
        self.bytes = 0
        self.tokens = 0
        self.seconds = 0.0

    def add(self, nbytes: int, ntokens: int, seconds: float) -> None:
        self.bytes += nbytes
        self.tokens += ntokens
        self.seconds += seconds

    @property
    def mb_per_s(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "tokenizer_type": self.tokenizer_type,
                "bytes": self.bytes,
                "tokens": self.tokens,
                "seconds": round(self.seconds, 4),
                "throughput_mb_s": round(self.mb_per_s, 2),
                "tokens_per_s": round(self.tokens_per_s, 1),
            }
        )

"""Tracing and profiling helpers.

* ``profile_trace(dir)``: a ``torch.profiler`` trace of host and (with a
  card) CUDA activity, written to ``dir`` as a Chrome/Perfetto trace.
* ``device_busy_us(dir)``: the device's busy time in such a trace, from
  which a caller derives the device's idle share of a wall interval.
* ``stage_device_us(events, stages)``: the device time each
  ``torch.profiler.record_function`` range launched, and
  ``kernel_counts(events, names)`` the trace's kernel events by name.
* ``span(name)``: a ``torch.profiler.record_function`` range named
  ``name`` while a trace records, and nothing otherwise; the engine and
  the wrapper mark their host work with ``td.*`` spans, and a
  ``gc.callbacks`` hook marks each collection ``td.gc``.
* ``RateMeter``: bytes/tokens throughput accounting; its JSON schema is
  the JAX package's (``tokendagger_tpu/utils/profiling.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import re
from pathlib import Path
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler


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


class span:
    """``with span("td.window"): ...``: a ``record_function`` range named
    ``name`` while a ``torch.profiler`` trace records, so that the range
    lies on the clock of the trace's kernels and copies; otherwise it
    only reads the profiler's module flag (a ``record_function`` costs
    ~14 µs even with no profiler running). A span marks a call or a
    stage, never a piece, an id or a loop iteration: those are counted."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        """Close the range if ``__enter__`` opened one (once; else
        nothing)."""
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)


class _GcSpan:
    """A ``gc.callbacks`` hook: a ``td.gc`` span around each collection
    while a trace records, so that a pause is not charged to the span that
    happened to be open. A collection starts and stops on one thread and
    never nests."""

    __slots__ = ("_span",)

    def __init__(self) -> None:
        self._span = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _autograd_profiler._is_profiler_enabled:
                self._span = span("td.gc").__enter__()
        elif self._span is not None:
            sp, self._span = self._span, None
            sp.__exit__(None, None, None)


if not any(isinstance(cb, _GcSpan) for cb in gc.callbacks):
    gc.callbacks.append(_GcSpan())


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

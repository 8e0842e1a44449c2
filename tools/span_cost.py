"""What the port's ``td.*`` spans (``utils/profiling.span``) cost, on one
NVIDIA card.

    python3 tools/span_cost.py [--seed N] [--units K] [--against DIR
                               [--seconds S]]

1. Off: ns per ``with span(...)`` while no profiler records (``timeit``,
   best of 5 runs of 1,000,000), beside a bare ``with`` of a no-op object
   and an unguarded ``record_function``; and whether torch's module flag
   ``torch.autograd.profiler._is_profiler_enabled`` reads True inside
   ``torch.profiler.profile`` and False outside it.
2. On: the benchmark's ``cl100k.prompts`` cell (its configuration, stand-in
   vocabulary and units from ``--seed``, as ``tdbench/run.py`` makes them)
   through ``Tokenizer(backend="device", device="cuda")``: after warm-up,
   the ``--units`` slice calls (``tdbench.traffic.spread``, the traced
   slice's units) timed one by one without the profiler, under a
   ``torch.profiler`` trace (CPU and CUDA activity), and without it again;
   the median latency of each pass, and the ``td.*`` ranges a call opens.
3. With ``--against DIR``: the same units through this checkout's port and
   through ``DIR``'s (another checkout, loaded under another name), with no
   profiler, the two calls of each unit in turns (AB, then BA) over all the
   cell's units in order for ``--seconds``: the median and the 95th
   percentile of each side. Both run in this process, with this
   checkout's ``gc.callbacks`` hook.

Prints the card's name and power limit first, one line a reading.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
import timeit
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def ns_per(stmt: str, glob: dict, number: int = 1_000_000) -> float:
    return min(timeit.repeat(stmt, globals=glob, number=number,
                             repeat=5)) / number * 1e9


def off_cost() -> None:
    import torch
    import torch.autograd.profiler as ap

    from tokendagger_tpu_torch.utils.profiling import span

    glob = {"span": span, "noop": _Noop(),
            "rf": torch.profiler.record_function}
    guarded = ns_per("with span('td.x'): pass", glob)
    bare = ns_per("with noop: pass", glob)
    unguarded = ns_per("with rf('td.x'): pass", glob, 20_000)
    print(f"off: span {guarded:.1f} ns, bare with {bare:.1f} ns, "
          f"record_function {unguarded:.1f} ns")
    outside = ap._is_profiler_enabled
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]):
        inside = ap._is_profiler_enabled
    print(f"flag: outside {outside}, inside {inside}, after "
          f"{ap._is_profiler_enabled} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")


def on_cost(seed: int, k: int) -> None:
    import torch

    import tokendagger_tpu_torch as tt
    from tdbench import run, traffic
    from tdbench.byname import load
    from tdbench.standin import standin_ranks

    _, _, config, mix = run.load_cell("cl100k.prompts")
    api = load("calls", mix["call"])
    ranks = standin_ranks(config, seed)
    units = traffic.make_units(mix, seed)
    unit_bytes = [sum(len(t.encode("utf-8")) for t in api.texts(u))
                  for u in units]
    tok = tt.Tokenizer(config["name"], pat_str=config["pat_str"],
                       mergeable_ranks=ranks,
                       special_tokens=dict(config["special_tokens"]),
                       backend="device", device="cuda")
    call = api.bind(tok)
    for i in traffic.warmup(unit_bytes):
        call(units[i])
    idx = traffic.spread(unit_bytes, k)

    def timed() -> list[float]:
        out = []
        for i in idx:
            t = time.perf_counter()
            call(units[i])
            out.append(time.perf_counter() - t)
        return out

    off1 = timed()
    with warnings.catch_warnings(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")
        call(units[idx[0]])              # the trace settles
        torch.cuda.synchronize()
        on = timed()
    off2 = timed()
    # the host's ranges only: a range that launched device work also
    # appears as a device-side annotation of the same name
    host = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sum(1 for n in host if n.startswith("td."))
    calls = host.count("td.encode")
    med = [statistics.median(x) * 1e3 for x in (off1, on, off2)]
    print(f"on: {len(idx)} prompt calls ({sum(unit_bytes[i] for i in idx)} "
          f"B), median ms off {med[0]:.4f}, traced {med[1]:.4f}, off again "
          f"{med[2]:.4f}: traced / off {med[1] / ((med[0] + med[2]) / 2):.3f};"
          f" {spans / max(calls, 1):.1f} td.* ranges a call ({calls} calls)")


def load_port(root: Path, name: str):
    """The port package of the checkout at ``root``, imported as ``name``."""
    pkg = root / "tokendagger_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def against(seed: int, other: Path, seconds: float) -> None:
    import numpy as np

    import tokendagger_tpu_torch as tt
    from tdbench import run, traffic
    from tdbench.byname import load
    from tdbench.standin import standin_ranks

    _, _, config, mix = run.load_cell("cl100k.prompts")
    api = load("calls", mix["call"])
    ranks = standin_ranks(config, seed)
    units = traffic.make_units(mix, seed)
    unit_bytes = [sum(len(t.encode("utf-8")) for t in api.texts(u))
                  for u in units]
    calls = []
    for port in (tt, load_port(other, "tokendagger_tpu_torch_other")):
        tok = port.Tokenizer(config["name"], pat_str=config["pat_str"],
                             mergeable_ranks=ranks,
                             special_tokens=dict(config["special_tokens"]),
                             backend="device", device="cuda")
        call = api.bind(tok)
        for i in traffic.warmup(unit_bytes):
            call(units[i])
        calls.append(call)
    lat: list[list[float]] = [[], []]
    deadline = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < deadline:
        unit = units[i % len(units)]
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            t = time.perf_counter()
            calls[side](unit)
            lat[side].append(time.perf_counter() - t)
        i += 1
    (m0, p0), (m1, p1) = [(np.median(x) * 1e3, np.percentile(x, 95) * 1e3)
                          for x in lat]
    print(f"against {other}: {i} prompt calls a side; median ms this "
          f"{m0:.4f}, other {m1:.4f} ({m0 / m1:.4f}); p95 ms this {p0:.4f},"
          f" other {p1:.4f} ({p0 / p1:.4f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    off_cost()
    on_cost(args.seed, args.units)
    if args.against is not None:
        against(args.seed, args.against.resolve(), args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

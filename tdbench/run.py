"""tdbench: the benchmark of the PyTorch/CUDA port, ``tokendagger_tpu_torch``.

    python3 tdbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, on the card, from the root of a
checkout, and prints one JSON line (the last line of standard output).

1. Set-up (``setup_s``): from the start of this file to the end of
   warm-up, less the time the benchmark takes to make its own data (the
   configuration's stand-in vocabulary, ``standin.py``, and the traffic's
   units, ``traffic.py``, both from ``--seed``): imports, the CUDA
   context, the kernels (built into the port's ``_build/`` inside the
   checkout by the first run there),
   ``Tokenizer(backend="device", device="cuda")``, then one call of a unit
   of each octave of size (``traffic.warmup``).
2. The window: the mix's loop (``loops/<loop>.py``) drives the mix's call
   (``calls/<call>.py``) over the units for ``--seconds``. Every call's
   latency and bytes are kept, and the ids of the first call of each
   unit and of a share (``check_share``) of the others, drawn from the
   seed. The objects made in set-up are frozen out of the garbage
   collector's passes first (``gc.freeze``).
3. With ``--trace 1``, or where one of the cell's end-to-end metrics is
   read from the device trace (``source`` ``device_trace``), a traced
   slice: one more untraced call, one traced call, then the mix's
   ``trace_units`` calls inside the range ``tdbench.slice`` of a
   ``torch.profiler`` trace written under the temporary directory
   (``TMPDIR``). Only a ``--trace 1`` line carries ``busy_s``,
   ``window_s`` and ``breakdown``.
4. The peak device memory is read and the tokenizer freed; then every
   kept call's ids are compared with the plain reference
   (``reference/encode.py``) on the same input: a call is wrong unless
   every id is equal. ``correct`` holds when no call failed or was wrong
   and at least one was checked.
5. No module of ``jax``, ``jaxlib``, ``flax`` or ``tokendagger_tpu`` may be
   loaded (top-level names compared whole); else the run exits 3 and
   prints no result.

Each metric is read by ``metrics/<name before the first dot>.py``
(``read(run) -> float | None``; None, where the run holds nothing to
read, leaves it out): with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. Without a card, or with fewer
than the cell's chips, the run exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# import the benchmark as the package ``tdbench`` and the port beside it
# (not the modules of this directory by their bare names)
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from tdbench import traffic  # noqa: E402
from tdbench.byname import load  # noqa: E402
from tdbench.reference.encode import Reference  # noqa: E402
from tdbench.seeds import sub_seed  # noqa: E402
from tdbench.standin import standin_ranks  # noqa: E402
from tdbench.trace import read_slice  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tokendagger_tpu")


@dataclass
class Run:
    """What one run measured; the metric readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    bytes: int = 0
    latencies_s: list = field(default_factory=list)
    stats: dict | None = None    # EngineStats deltas over the window
    slice: object = None         # trace.Slice of the traced slice


def load_cell(workload: str):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, mix


def cell_metrics(manifest: dict, cell: dict, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    a trace its per-layer ones."""
    def applies(m, default):
        return cell["name"] in m.get("workloads", default)
    e2e = [m for m in manifest["end_to_end"]
           if applies(m, [cell["name"]])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if m["moves"] in names and applies(m, [cell["name"]])]


def engine_stats(tok) -> dict:
    """The numeric counters of the port's ``DeviceEngine.stats``; a port
    without them fails the run, so that its metrics cannot go silent."""
    stats = getattr(getattr(tok, "_device", None), "stats", None)
    if stats is None:
        raise RuntimeError("the Tokenizer has no DeviceEngine.stats to read")
    return {k: v for k, v in vars(stats).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    out = subprocess.run([smi, "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "unknown")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", mix: dict | None = None,
             config: dict | None = None, t0: float = T0,
             program=None) -> tuple[dict, list]:
    """One run of ``workload``: (the result line's object, the compared
    numbers as (name, value, limit, "at most" or "at least")). ``mix`` and
    ``config`` replace the cell's files (for tests at small sizes);
    ``program(pat_str, ranks, specials)`` replaces the port by an object
    with the mix's call (the controls)."""
    import torch

    import tokendagger_tpu_torch as tt

    manifest, cell, cell_config, cell_mix = load_cell(workload)
    mix = mix or cell_mix
    config = config or cell_config
    api = load("calls", mix["call"])
    loop = load("loops", mix["loop"])
    dev = torch.device(device)
    if dev.type == "cuda":
        # every kernel at once (nvcc in parallel) on a fresh checkout
        from tokendagger_tpu_torch._build import build_all

        build_all()
        torch.cuda.init()
    t_made = time.perf_counter()
    ranks = standin_ranks(config, seed)
    specials = dict(config["special_tokens"])
    units = traffic.make_units(mix, seed)
    unit_bytes = [sum(len(t.encode("utf-8")) for t in api.texts(u))
                  for u in units]
    made_s = time.perf_counter() - t_made
    if program is None:
        tok = tt.Tokenizer(config["name"], pat_str=config["pat_str"],
                           mergeable_ranks=ranks, special_tokens=specials,
                           backend="device", device=dev)
    else:
        tok = program(config["pat_str"], ranks, specials)
    call = api.bind(tok)
    for i in traffic.warmup(unit_bytes):
        call(units[i])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run = Run(setup_s=time.perf_counter() - t0 - made_s)

    # the window
    keep = np.random.default_rng(sub_seed(seed, 30))
    share = float(mix["check_share"])
    kept, seen, failures = [], set(), []

    def record(u, latency_s, out, err):
        run.latencies_s.append(latency_s)
        run.bytes += unit_bytes[u]
        if err is not None:
            failures.append(err)
        elif u not in seen or keep.random() < share:
            seen.add(u)
            kept.append((u, out))

    stats0 = engine_stats(tok) if program is None else None
    gc.collect()
    gc.freeze()
    run.window_s = loop.drive(call, units, seconds, record)
    run.calls = len(run.latencies_s)
    if program is None:
        stats1 = engine_stats(tok)
        run.stats = {k: stats1[k] - stats0.get(k, 0) for k in stats1}

    if trace or any(m["source"] == "device_trace"
                    for m in cell_metrics(manifest, cell, False)):
        run.slice = traced_slice(api, call, units, unit_bytes,
                                 int(mix["trace_units"]), dev)
    info = card_info(dev)
    if trace and run.slice is not None:
        info["busy_s"] = run.slice.busy_us() * 1e-6
        info["window_s"] = run.slice.window_us * 1e-6
    del tok, call
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    wrong = check(api, kept, units, config, ranks, specials)
    compared = [("failed_calls", len(failures), 0, "at most"),
                ("wrong_calls", wrong, 0, "at most"),
                ("checked_calls", len(kept), 1, "at least")]
    correct = not failures and not wrong and len(kept) >= 1
    for f in failures[:1]:
        print(f"first failed call:\n{f}", file=sys.stderr)

    metrics = {}
    for m in cell_metrics(manifest, cell, trace):
        value = load("metrics", m["name"].split(".")[0]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.calls,
              "failed": len(failures), "metrics": metrics, "device": info}
    if trace and run.slice is not None:
        result["breakdown"] = {"device_ops": run.slice.device_ops(),
                               "idle_gaps": run.slice.idle_gaps()}
    result["check"] = {name: {"value": v, where.replace(" ", "_"): lim}
                       for name, v, lim, where in compared}
    return result, compared


def traced_slice(api, call, units: list, unit_bytes: list[int], k: int,
                 dev):
    """The trace of ``k`` calls (``traffic.spread``) after one untraced
    and one traced call, with the slice's work counted."""
    import torch

    idx = traffic.spread(unit_bytes, k)
    call(units[idx[0]])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    outs = []
    with warnings.catch_warnings(), torch.profiler.profile(
            activities=acts) as prof:
        warnings.simplefilter("ignore")
        call(units[idx[0]])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with torch.profiler.record_function("tdbench.slice"):
            for i in idx:
                outs.append(call(units[i]))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    sl = read_slice(events)
    if sl is None:
        return None
    texts = [t for i in idx for t in api.texts(units[i])]
    sl.bytes = sum(len(t.encode("utf-8")) for t in texts)
    sl.chars = sum(len(t) for t in texts)
    sl.ids = sum(api.n_ids(out) for out in outs)
    return sl


def check(api, kept: list, units: list, config: dict, ranks: dict,
          specials: dict) -> int:
    """Kept calls whose ids differ from the reference's on their unit."""
    ref = Reference(config["pat_str"], ranks, specials)
    want: dict[int, list] = {}
    wrong = 0
    for u, out in kept:
        if u not in want:
            want[u] = api.expected(ref, units[u])
        if out != want[u]:
            wrong += 1
    return wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must not be negative")
    _, cell, _, _ = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: tdbench measures the port on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, compared = run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["card"] = {"name": result["device"]["kind"],
                      "power_limit": power_limit()}
    result["check"] = result.pop("check")
    sys.stdout.flush()
    for name, v, lim, where in compared:
        print(f"check {name} {v} ({where} {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

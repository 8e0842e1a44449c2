"""Where K5+K6's time goes on one NVIDIA card: builds csrc/route.cu with
parts of record_kernel switched off or other block sizes, and times each
build device-only at the resident path's three K5+K6 shapes.

    python3 tools/k5_variants.py

Each variant is a copy of the source with one text replacement, built by
nvcc for sm_90a (its register and spill lines are printed) and timed, in
a process of its own (tools/variants.py), as chip_smoke.py times a
kernel: CUDA events around 20 launches enqueued behind a sleep kernel,
median of 5 runs. Variants that switch a part off
compute wrong outputs; they only say what that part costs. Shapes (rows,
elements -> cap, arrays, share of the mask set: the auto run of
chip_smoke.py at seed 0): decode (8, 1,048,576) -> 917,504, k 1, 0.854;
classes (8, 917,504) -> 102,144, k 1, 0.111; probe (8, 262,144) ->
91,776, k 5, 0.348. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SHAPES = (("decode", 8, 1 << 20, 917_504, 1, 0.854),
          ("classes", 8, 917_504, 102_144, 1, 0.111),
          ("probe", 8, 262_144, 91_776, 5, 0.348))

# name -> (text in route.cu, its replacement)
VARIANTS = {
    "as built": None,
    "no fill": ("if (t == T - 1 && s_total < cap) {", "if (false) {"),
    "no route stores": ("route[32 * j + lane] = keep ? rank : -1;",
                        "(void)0;"),
    "no value copies": ("if (keep && rank < cap) dense[rank] = v[j];", ""),
    "4 blocks per SM": ("__launch_bounds__(kThreads, 6)",
                        "__launch_bounds__(kThreads)"),
    "512 threads": ("kThreads = 256;", "kThreads = 512;"),
}


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_compact_record.argtypes = (
        [vp, i, i] + [vp] * 8 + [i, i, i, vp, vp, vp, vp, ctypes.c_uint, vp])
    lib.td_compact_record.restype = i
    return lib


def time_variant(name: str, path: Path) -> None:
    """Times the library at ``path`` at every shape (in this process)."""
    import torch

    from chip_smoke import device_ms

    lib = load(path)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    row = []
    for label, B, N, cap, k, share in SHAPES:
        mask = torch.rand((B, N), generator=g, device=dev) < share
        ins = [torch.randint(0, 1 << 30, (B, N), generator=g, device=dev,
                             dtype=torch.int32) for _ in range(k)]
        ptrs = [a.data_ptr() for a in ins] + [None] * (8 - k)
        out = torch.empty((k, B, cap), dtype=torch.int32, device=dev)
        route = torch.empty((B, N), dtype=torch.int32, device=dev)
        totals = torch.empty((B,), dtype=torch.int32, device=dev)
        status = torch.zeros(B * (N // 1024 + 1), dtype=torch.int64,
                             device=dev)
        epoch = [0]

        def run():
            epoch[0] += 1
            rc = lib.td_compact_record(
                mask.data_ptr(), B, N, *ptrs, k, cap, 0, out.data_ptr(),
                route.data_ptr(), totals.data_ptr(), status.data_ptr(),
                epoch[0], stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        row.append(f"{label} {device_ms(run):.4f}")
    print(f"{name}: " + ", ".join(row), flush=True)


def main() -> int:
    sys.path.insert(0, str(REPO))
    if len(sys.argv) == 3:
        time_variant(sys.argv[1], Path(sys.argv[2]))
        return 0
    from tools.variants import run

    print("shapes: " + "; ".join(
        f"{label} ({B}, {N}) -> {cap}, k {k}" for label, B, N, cap, k, _
        in SHAPES), flush=True)
    return run(__file__, "route.cu", VARIANTS, "record_kernel")


if __name__ == "__main__":
    sys.exit(main())

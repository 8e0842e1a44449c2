"""K1's block shape on one NVIDIA card: builds csrc/piece_starts.cu with
other (threads per block, blocks per SM) constants and times its
codepoint entry at the main paths' shapes.

    python3 tools/k1_variants.py

Each variant is a copy of the source with ``kThreads`` and
``kBlocksPerSm`` replaced, built by nvcc for sm_90a (its register and
spill lines are printed), checked equal to the default build on the same
windows, and timed device-only: CUDA events around 20 launches enqueued
back to back, median of 5 runs. Shapes: 8 windows of 1,048,576 chars
(the resident path) and one of 4,194,304 (the engine's window), seeded
codepoints of mixed classes, profile llama4. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

VARIANTS = ((512, 2), (512, 1), (1024, 1), (256, 4), (256, 8))
SHAPES = ((8, 1 << 20), (1, 1 << 22))


def build(src: str, threads: int, per_sm: int, out: Path) -> ctypes.CDLL:
    from tokendagger_tpu_torch._build import CSRC, NVCC_FLAGS, _nvcc

    text = re.sub(r"kThreads = \d+;", f"kThreads = {threads};", src)
    text = re.sub(r"kBlocksPerSm = \d+;", f"kBlocksPerSm = {per_sm};", text)
    cu = out.with_suffix(".cu")
    cu.write_text(text)
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                          str(out), str(cu)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    regs = sorted({ln.split(":", 1)[-1].strip()
                   for ln in (log.stdout + log.stderr).splitlines()
                   if "registers" in ln or "spill" in ln})
    print(f"build {threads} x {per_sm}: " + "; ".join(regs), flush=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_piece_starts_cp.argtypes = [vp, vp, i, i, i, vp, vp, vp, vp]
    lib.td_piece_starts_cp.restype = i
    lib.td_piece_starts_blocks.argtypes = [i, i, i]
    lib.td_piece_starts_blocks.restype = i
    return lib


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from tokendagger_tpu_torch._build import CSRC
    from tokendagger_tpu_torch.ops.bitplane import _class_words

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    src = (CSRC / "piece_starts.cu").read_text()
    dev = torch.device("cuda")
    table = _class_words("llama4", "cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    pool = torch.tensor([0x20, 0x61, 0x41, 0x30, 0x27, 0x2E, 0x0A, 0x3000,
                         0x65E5, 0x1F642, 0x301, 0x17F, 0x3B1, 0x410],
                        dtype=torch.int32, device=dev)
    inputs = {}
    for B, N in SHAPES:
        cp = pool[torch.randint(0, len(pool), (B, N), generator=g,
                                device=dev)].contiguous()
        m = torch.full((B,), N - 1000, dtype=torch.int32, device=dev)
        inputs[(B, N)] = (cp, m)
    want = {}
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor() as ex:
        libs = [ex.submit(build, src, t, b, Path(d) / f"libk1_{t}_{b}.so")
                for t, b in VARIANTS]  # one nvcc per variant, in parallel
        for (threads, per_sm), job in zip(VARIANTS, libs):
            lib = job.result()
            for (B, N), (cp, m) in inputs.items():
                scratch = torch.empty(B * 48 * (N // 32), dtype=torch.int32,
                                      device=dev)
                out = torch.empty((B, N // 32), dtype=torch.int32,
                                  device=dev)
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    rc = lib.td_piece_starts_cp(
                        cp.data_ptr(), m.data_ptr(), B, N, 0,
                        table.data_ptr(), scratch.data_ptr(),
                        out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"CUDA error {rc}")

                run()
                torch.cuda.synchronize()
                ref = want.setdefault((B, N), out.clone())
                same = bool(torch.equal(out, ref))
                times = []
                for _ in range(5):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    for _ in range(20):
                        run()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e) / 20)
                spw = lib.td_piece_starts_blocks(1, B, N)
                print(f"K1 codepoints {(B, N)}, {threads} threads x "
                      f"{per_sm} per SM, {spw} blocks per window: "
                      f"{statistics.median(times):.4f} ms; equal to the "
                      f"first variant: {same}")
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

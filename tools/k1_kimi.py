"""K1 under the kimi profile (Kimi K2's pattern: its Han rules in front of
the o200k derivation) beside llama4, on one NVIDIA card.

    python3 tools/k1_kimi.py [--parent DIR]

Prints the card's name and power limit, the registers and spills nvcc
reports for csrc/piece_starts.cu, then for each shape the passes K1 makes
and its device-only time under llama4 and under kimi on the same
Chinese-English codepoints (CUDA events around 20 launches enqueued back
to back behind a sleep kernel, median of 5 runs), each kimi result first
checked equal to the plain version run on the card. Shapes: the engine's
4 MB window (4,194,304 char slots) holding 4 MB of text, and the same
window full; the row entry at (1024, 1024) and (256, 4096). The bound is
PERF.md's: 4 bytes a codepoint read and 1 bit a char written at 3.35
TB/s. With ``--parent DIR`` (a checkout of another commit) it also builds
DIR's csrc/piece_starts.cu, prints its registers and spills, checks its
codepoint entry equal on the 4 MB windows under llama4 and times both
builds there in turns (parent, this, this, parent), and so under cl100k
on the rows (the prompts' entry).
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12


def device_ms(fn, reps: int = 20, runs: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-4)))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def build(csrc: Path, out: str) -> list[str]:
    """nvcc's register and spill lines for csrc/piece_starts.cu, built as
    the port builds it into ``out``."""
    from tokendagger_tpu_torch._build import NVCC_FLAGS, _nvcc

    log = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", out,
         str(csrc / "piece_starts.cu")], capture_output=True, text=True)
    text = log.stdout + log.stderr
    if log.returncode:
        raise RuntimeError(text)
    return [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def cp_entry(lib):
    """The codepoint entries of a K1 library: fn(cp, m, table, profile id)
    -> words, by the row entry for rows of at most 4,096 chars."""
    import ctypes

    import torch

    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_piece_starts_cp.argtypes = [vp, vp, i, i, i, vp, vp, vp, vp]
    lib.td_piece_starts_cp.restype = i
    lib.td_piece_starts_cp_rows.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.td_piece_starts_cp_rows.restype = i
    lib.td_piece_starts_scratch_words.argtypes = [i]
    lib.td_piece_starts_scratch_words.restype = ctypes.c_longlong

    def run(cp, m, table, profile):
        B, N = cp.shape
        out = torch.empty((B, N // 32), dtype=torch.int32, device=cp.device)
        stream = torch.cuda.current_stream().cuda_stream
        if N <= 4096:
            rc = lib.td_piece_starts_cp_rows(
                cp.data_ptr(), m.data_ptr(), B, N, profile, table.data_ptr(),
                out.data_ptr(), stream)
        else:
            scratch = torch.empty(B * lib.td_piece_starts_scratch_words(N),
                                  dtype=torch.int32, device=cp.device)
            rc = lib.td_piece_starts_cp(
                cp.data_ptr(), m.data_ptr(), B, N, profile, table.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
        return out
    return run


def main() -> int:
    import argparse
    import ctypes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import torch

    from tokendagger_tpu_torch.ops import bitplane as BP
    from torch_port_util import han_text

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print("card:", smi.stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    libs = {}
    for name, csrc in (("this", ROOT / "tokendagger_tpu_torch" / "csrc"),
                       ("parent", args.parent and args.parent
                        / "tokendagger_tpu_torch" / "csrc")):
        if csrc is None:
            continue
        for ln in build(csrc, f"{tmp}/{name}.so"):
            print(f"ptxas {name}:", ln, flush=True)
        libs[name] = cp_entry(ctypes.CDLL(f"{tmp}/{name}.so"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    N = 1 << 22
    text = han_text(rng, N)
    doc = text.encode()[:N].decode("utf-8", "ignore")
    cases = []
    for label, chars in (("4 MB window, 4 MB of text", doc),
                         ("4 MB window, full", text)):
        cp = np.zeros((1, N), np.int32)
        cp[0, :len(chars)] = [ord(c) for c in chars]
        cases.append((label, torch.from_numpy(cp).to(dev),
                      torch.tensor([len(chars)], dtype=torch.int32,
                                   device=dev)))
    for B, W in ((1024, 1024), (256, 4096)):
        cp = np.zeros((B, W), np.int32)
        m = np.zeros(B, np.int32)
        for b in range(B):
            k = int(rng.integers(W // 2, W + 1))
            cp[b, :k] = [ord(c) for c in han_text(rng, k)]
            m[b] = k
        cases.append((f"rows ({B}, {W})", torch.from_numpy(cp).to(dev),
                      torch.from_numpy(m).to(dev)))
    if "parent" in libs:
        for profile, which in (("llama4", cases[:2]), ("cl100k", cases[2:])):
            table = BP._class_words(profile, str(dev))
            pid = BP._PROFILE_ID[profile]
            for label, cp, m in which:
                got = {k: f(cp, m, table, pid) for k, f in libs.items()}
                torch.cuda.synchronize()
                if not torch.equal(got["this"], got["parent"]):
                    print(f"{label}: {profile} K1 differs from the "
                          "parent's", flush=True)
                    return 1
                times = {k: [] for k in libs}
                for k in ("parent", "this", "this", "parent"):
                    times[k].append(device_ms(
                        lambda: libs[k](cp, m, table, pid)))
                print(f"{label}: {profile}, parent " + ", ".join(
                    f"{t:.4f}" for t in times["parent"]) + " ms; this "
                    + ", ".join(f"{t:.4f}" for t in times["this"]) + " ms",
                    flush=True)
    for label, cp, m in cases:
        B, W = cp.shape
        want = BP.piece_starts_chars_plain(cp, m, profile="kimi")
        got = BP.piece_starts_chars(cp, m, profile="kimi", packed_out=True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            print(f"{label}: kimi K1 differs from the plain version",
                  flush=True)
            return 1
        bound = (B * W * 4 + B * W / 8) / HBM_BYTES_PER_S * 1e3
        row = [f"{label}: chars {int(m.sum())}, bound {bound:.5f} ms"]
        for profile in ("llama4", "kimi"):
            ms = device_ms(lambda: BP.piece_starts_chars(
                cp, m, profile=profile, packed_out=True))
            row.append(f"{profile} {ms:.4f} ms "
                       f"({BP.starts_passes(profile, W)} passes)")
        print("; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

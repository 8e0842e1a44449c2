"""Barrier latency on one NVIDIA card, for the design of kernel K1
(tokendagger_tpu_torch/csrc/piece_starts.cu): a cooperative grid barrier
against a thread-block cluster barrier, and the clusters the card holds.

    python3 tools/barrier_probe.py

Builds tools/barrier_probe.cu with nvcc for sm_90a into a temporary
directory, runs it, and prints its lines after the card's name and power
limit.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from tokendagger_tpu_torch._build import _nvcc

    src = Path(__file__).with_suffix(".cu")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        exe = Path(d) / "barrier_probe"
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-o", str(exe), str(src)],
                       check=True)
        return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())

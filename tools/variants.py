"""Kernel variants on one NVIDIA card: the part tools/k5_variants.py and
tools/k23_variants.py share. Builds a CUDA source of
tokendagger_tpu_torch/csrc once per variant (one text replacement each)
and runs the calling script once per build, in a process of its own, to
time it.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def build(source: str, change, name: str, kernel: str, out: Path) -> Path:
    """csrc/``source`` with ``change`` = (old, new), or a list of such
    pairs in turn, replaced at every occurrence (None: as it is), built by
    nvcc for sm_90a into ``out``; prints ``kernel``'s register and spill
    lines."""
    from tokendagger_tpu_torch._build import CSRC, NVCC_FLAGS, _nvcc

    text = (CSRC / source).read_text()
    pairs = [] if change is None else (
        change if isinstance(change, list) else [change])
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    cu = out.with_suffix(".cu")
    cu.write_text(text)
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                          str(out), str(cu)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    regs, ours = [], False
    for ln in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in ln:
            ours = kernel in ln
        elif ours and ("registers" in ln or "spill" in ln):
            regs.append(ln.split(":", 1)[-1].strip())
    print(f"build {name}: {'; '.join(regs)}", flush=True)
    return out


def run(script: str, source: str, variants: dict, kernel: str,
        prepare=None) -> int:
    """Prints the card's name and power limit, builds every variant of
    csrc/``source`` (one nvcc each, in parallel, while ``prepare(dir)``
    makes the inputs and returns the arguments that name them), then runs
    ``python script <variant> <library> <arguments>`` once per variant and
    prints its output. Returns 1 if a variant failed."""
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        with ThreadPoolExecutor(len(variants)) as ex:
            libs = [ex.submit(build, source, change, name, kernel,
                              Path(d) / f"lib{Path(source).stem}_{i}.so")
                    for i, (name, change) in enumerate(variants.items())]
            args = prepare(Path(d)) if prepare else []
            libs = [lib.result() for lib in libs]
        print("ms device-only", flush=True)
        failed = 0
        for name, lib in zip(variants, libs):
            rc = subprocess.run([sys.executable, script, name, str(lib),
                                 *args], capture_output=True, text=True)
            print(rc.stdout.strip() if rc.returncode == 0 else
                  f"{name}: failed: {rc.stderr.strip().splitlines()[-1]}",
                  flush=True)
            failed += rc.returncode != 0
    return 1 if failed else 0

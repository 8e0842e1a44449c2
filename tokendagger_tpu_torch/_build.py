"""Build and load the package's hand-written kernels at first use.

Each CUDA source ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into
a shared library with a plain C interface and loaded with ctypes. Builds
land in ``_build/`` beside this file (ignored by git), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
is reused. ``build_all`` starts one nvcc per source at once.

``csrc/piece_starts_host.cpp`` is the host build of the K1 derivation and
``csrc/merge_host.cpp`` that of the merge's row routines and
``csrc/probe_host.cpp`` that of the probe's piece routines, for the CPU
tests; they are compiled the same way with the system C++ compiler.

``native_build`` compiles the native host engine (``native/tdnative.cpp``,
and with ``native/tdpy.cpp`` its CPython extension) with g++ into the same
directory, with OpenMP where the toolchain has it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("_build")
CUDA_SOURCES = ("piece_starts", "compact", "utf8", "route", "merge",
                "probe")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
NATIVE_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                "-fopenmp")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(cand)


def _target(src: Path, flags: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path, compiler: str, flags: tuple[str, ...]):
    """Start compiling ``src`` unless its library exists; returns
    (target, process or None, tmp path)."""
    out = _target(src, flags)
    if out.exists():
        return out, None, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.Popen(
        [compiler, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc, tmp


def _finish(out: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"building {out.name} failed:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every CUDA source (in parallel) that is not built yet."""
    nvcc = _nvcc()
    jobs = {n: _start(CSRC / f"{n}.cu", nvcc, NVCC_FLAGS)
            for n in CUDA_SOURCES}
    for out, proc, tmp in jobs.values():
        _finish(out, proc, tmp)
    return {n: job[0] for n, job in jobs.items()}


@lru_cache(maxsize=None)
def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    out, proc, tmp = _start(CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS)
    _finish(out, proc, tmp)
    return ctypes.CDLL(str(out))


@lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp`` built with the host C++
    compiler (``CXX`` or g++)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    out, proc, tmp = _start(CSRC / f"{name}.cpp", cxx, CXX_FLAGS)
    _finish(out, proc, tmp)
    return ctypes.CDLL(str(out))


def _cpu_tag() -> bytes:
    """The host CPU's feature flags: ``-march=native`` code built on one
    machine may not run (or not run as tuned) on another that loads the
    same tree."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return platform.processor().encode()


def native_build(name: str, sources: tuple[Path, ...],
                 extra: tuple[str, ...] = (),
                 timeout: float = 180) -> Path | None:
    """Compile ``sources`` with g++ into ``_build/<name>_<hash>.so`` unless
    it exists, retrying without ``-fopenmp`` (the batch entry points then
    run serially); None when neither build succeeds. The target is named
    by a hash of the sources, the flags and the CPU's features and written
    through a pid-unique temporary file, so concurrent first uses do not
    interleave."""
    h = hashlib.sha256(" ".join(NATIVE_FLAGS + extra).encode())
    h.update(_cpu_tag())
    for src in sources:
        h.update(src.read_bytes())
    out = BUILD / f"{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *NATIVE_FLAGS, *extra, *map(str, sources), "-o", str(tmp)]
    for attempt in (cmd, [c for c in cmd if c != "-fopenmp"]):
        try:
            subprocess.run(attempt, check=True, capture_output=True,
                           timeout=timeout)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out
    tmp.unlink(missing_ok=True)
    return None

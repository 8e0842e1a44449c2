"""The slice as a whole: the port's ResidentStream on the CPU equals the
JAX package's ResidentStream (Pallas kernels in interpret mode) and the
host engine, window for window, with non-ASCII and overflow windows
counted as host fallbacks; and the port imports nothing of JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import make_tiny_vocab
from tokendagger_tpu.residentstream import ResidentStream as JaxStream
from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine, ResidentStream
from tokendagger_tpu_torch.utils.windows import stream_windows
from torch_port_util import prose_text

REPO = Path(__file__).resolve().parent.parent
W = 1 << 15


def _corpus_and_vocab():
    rng = np.random.default_rng(7)
    prose = prose_text(rng, 3 * W)
    dense = ("a " * W)[:W]                       # 2 B/piece: overflows p_cap
    accent = prose_text(rng, W - 100) + " café "  # one non-ASCII window
    tail = prose_text(rng, 5000)
    corpus = (prose + dense + accent + tail).encode("utf-8")
    ranks, specials = make_tiny_vocab()
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    pieces = sorted({prose[a:b].encode() for a, b in host.split_spans(prose[:W])})
    for p in pieces:
        ranks.setdefault(p, len(ranks) + 1000)
    return corpus, ranks, specials


def test_stream_equals_jax_and_host():
    corpus, ranks, specials = _corpus_and_vocab()
    port = ResidentStream(ranks, specials, LLAMA4_PATTERN, window=W, batch=2,
                          device="cpu")
    got, st = port.encode(corpus)
    ref = JaxStream(ranks, specials, LLAMA4_PATTERN, window=W, batch=2,
                    interpret=True)
    want, wst = ref.encode(corpus)
    wins = stream_windows(corpus, W)
    assert len(got) == len(want) == len(wins) == st.n_windows == 6
    for i, w in enumerate(wins):
        oracle = port.host.encode_ordinary(w.tobytes().decode("utf-8"))
        assert got[i] == want[i] == oracle, f"window {i}"
    assert st.host_fallback_windows == wst.host_fallback_windows == 2
    assert st.n_batches == wst.n_batches == 3
    assert st.spliced_pieces == wst.spliced_pieces > 0
    assert st.bytes_total == len(corpus)


def _missing_words(rng, n: int) -> bytes:
    """n bytes of ASCII words of 2-200 random letters: the tiny vocabulary
    holds almost none of them, and many are over 64 bytes."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    parts, size = [], 0
    while size < n:
        k = int(rng.integers(2, 200 if rng.random() < 0.2 else 12))
        parts.append(b" " + rng.choice(letters, k).tobytes())
        size += k + 1
    return b"".join(parts)[:n]


@pytest.mark.parametrize("route", ["native", "python"])
def test_stream_splices_many_misses_through_both_routes(route):
    """ASCII windows whose pieces the tiny vocabulary mostly misses:
    ResidentStream's ``Splicer`` gives the host engine's ids, window for
    window, on its native route and on its Python loop."""
    ranks, specials = make_tiny_vocab()
    corpus = _missing_words(np.random.default_rng(12), 2 * W + 3000)
    port = ResidentStream(ranks, specials, LLAMA4_PATTERN, window=W, batch=2,
                          device="cpu")
    if route == "python":
        port._splicer.native = None
    elif port._splicer.native is None:
        pytest.skip("no C++ toolchain for tdnative.cpp")
    got, st = port.encode(corpus)
    wins = stream_windows(corpus, W)
    assert len(got) == len(wins) == 3
    for i, w in enumerate(wins):
        oracle = port.host.encode_ordinary(w.tobytes().decode("utf-8"))
        assert got[i] == oracle, f"window {i}"
    assert st.host_fallback_windows == 0
    assert st.spliced_pieces > 2000
    assert (port._splicer.native is not None) == (route == "native")


def test_stream_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ranks, specials = make_tiny_vocab()
    with pytest.raises(RuntimeError):
        ResidentStream(ranks, specials, LLAMA4_PATTERN)


def test_stream_rejects_bad_window():
    ranks, specials = make_tiny_vocab()
    with pytest.raises(ValueError):
        ResidentStream(ranks, specials, LLAMA4_PATTERN, window=1000,
                       device="cpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "tokendagger_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {f.name for f in files}
    for new in ("engine.py", "wrapper.py", "streaming.py", "pretokenize.py",
                "decode.py", "resident.py", "profiling.py", "merge.py",
                "fused.py", "join.py", "mesh.py", "sharded_text.py",
                "resident_mesh.py", "windows.py", "tables.py"):
        assert new in names, new
    assert REPO / "tokendagger_tpu_torch" / "parallel" / "__init__.py" in files
    assert REPO / "tokendagger_tpu_torch" / "native" / "__init__.py" in files
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tokendagger_tpu"), (f, mod)


def test_port_import_loads_no_jax():
    code = ("import sys, tokendagger_tpu_torch, "
            "tokendagger_tpu_torch.residentstream, "
            "tokendagger_tpu_torch.convert, tokendagger_tpu_torch.engine, "
            "tokendagger_tpu_torch.wrapper, tokendagger_tpu_torch.streaming, "
            "tokendagger_tpu_torch.ops.pretokenize, "
            "tokendagger_tpu_torch.ops.decode, "
            "tokendagger_tpu_torch.ops.merge, "
            "tokendagger_tpu_torch.ops.fused, "
            "tokendagger_tpu_torch.resident, "
            "tokendagger_tpu_torch.native, "
            "tokendagger_tpu_torch.utils.profiling, "
            "tokendagger_tpu_torch.utils.windows, "
            "tokendagger_tpu_torch.tables, tokendagger_tpu_torch.ops.join, "
            "tokendagger_tpu_torch.parallel, "
            "tokendagger_tpu_torch.parallel.mesh, "
            "tokendagger_tpu_torch.parallel.sharded_text, "
            "tokendagger_tpu_torch.parallel.resident_mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tokendagger_tpu', 'regex')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

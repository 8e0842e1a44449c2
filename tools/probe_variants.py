"""Where the whole-piece probe's time goes on one NVIDIA card: builds
csrc/probe.cu with its design choices switched, and times each build
device-only at the shapes the main paths give the probe.

    python3 tools/probe_variants.py [--only NAME,NAME...]

Each variant is a copy of the source with text replaced, built by
nvcc for sm_90a (its register and spill lines are printed) and timed, in
a process of its own (tools/variants.py), as chip_smoke.py times a
kernel: CUDA events around 20 launches enqueued behind a sleep kernel,
median of 5 runs ("as built" and the named variants only with
--only). Each variant's output is held against the plain
version ("exact" or "differs"); the variants that read less than the
contract needs differ, and only say what the reads they drop cost.
Inputs (seed 0, made once and shared by every variant), on the engine
phase's 200,000-rank stand-in table (2^18 buckets):
- stream: chip_smoke.py's ASCII text in eight 1 MB windows, K1's packed
  flags, p_cap 349,568;
- resident: eight 1 MB windows of its multi-script text, byte flags,
  p_cap 349,568 (capacity 3.0);
- engine: one 4 MB window of that text, byte flags, p_cap 1,398,144.
Before the variants the parent prints, at each shape, the pieces, the
share of live and of hit pieces, the bytes bound (keys and output, and
each table row the pieces touch, once), the plain version's synchronized
call and ``rows.index_select(0, h)`` alone (the gather any torch
formulation pays), device-only. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# a persisting L2 window over the table, set once
_PERSIST = """  static bool persist = false;
  if (!persist) {
    int dev = 0;
    cudaDeviceProp prop;
    if (cudaGetDevice(&dev) || cudaGetDeviceProperties(&prop, dev))
      return 901;
    const size_t bytes = (size_t)(mask + 1) * 48 * sizeof(int);
    const size_t most = (size_t)prop.accessPolicyMaxWindowSize;
    const size_t win = bytes < most ? bytes : most;
    const size_t cap = (size_t)prop.persistingL2CacheMaxSize;
    const size_t keep = win < cap ? win : cap;
    if (cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, keep)) return 902;
    cudaStreamAttrValue v = {};
    v.accessPolicyWindow.base_ptr = const_cast<void*>(rows);
    v.accessPolicyWindow.num_bytes = win;
    v.accessPolicyWindow.hitRatio = (float)keep / (float)win;
    v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    if (cudaStreamSetAttribute(st, cudaStreamAttributeAccessPolicyWindow, &v))
      return 903;
    persist = true;
  }
"""
_LAUNCH = "  const long long blocks = (P + kThreads - 1) / kThreads;"
_STORE = "  __stcs(out + i, td_probe::probe_piece(rows, mask, q));"
_BODY = """\
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const td_probe::Query q{__ldcs(k0 + i), __ldcs(k1 + i), __ldcs(k2 + i),
                          __ldcs(k3 + i), __ldcs(len + i)};
""" + _STORE

# name -> (text in probe.cu, its replacement at every occurrence), or a
# list of such pairs
VARIANTS = {
    "as built": None,
    "no evict-first hints": [("__ldcs(", "*("), (
        _STORE, "  out[i] = td_probe::probe_piece(rows, mask, q);")],
    "row read whole": (_STORE, """\
  const int* row = td_probe::bucket_row(rows, mask, q);
  int w[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row) + j);
    w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z;
    w[4 * j + 3] = v.w;
  }
  int r = -1;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (w[32 + s] == q.len && w[s] == q.k0 && w[8 + s] == q.k1 &&
        w[16 + s] == q.k2 && w[24 + s] == q.k3)
      r = max(r, w[40 + s]);
  __stcs(out + i, r);"""),
    "rank read with the keys": (_STORE, """\
  const int* row = td_probe::bucket_row(rows, mask, q);
  int r = -1;
  for (unsigned m = td_probe::len_hits(row, q.len); m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    const int a = __ldg(row + s), b = __ldg(row + 8 + s),
              c = __ldg(row + 16 + s), d = __ldg(row + 24 + s),
              v = __ldg(row + 40 + s);
    if (a == q.k0 && b == q.k1 && c == q.k2 && d == q.k3) r = max(r, v);
  }
  __stcs(out + i, r);"""),
    "256 threads a block": ("kThreads = 128;", "kThreads = 256;"),
    "512 threads a block": ("kThreads = 128;", "kThreads = 512;"),
    "persisting L2 window on the table": (_LAUNCH, _PERSIST + _LAUNCH),
    # lane s of a piece's 8 reads slot s's length, then its words and rank;
    # the row's maximum by xor shuffles
    "8 lanes a piece": [(_BODY, """\
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / 8;
  const int s = (int)(t % 8);
  int r = -1;
  if (i < P) {
    const td_probe::Query q{__ldcs(k0 + i), __ldcs(k1 + i), __ldcs(k2 + i),
                            __ldcs(k3 + i), __ldcs(len + i)};
    const int* row = td_probe::bucket_row(rows, mask, q);
    if (__ldg(row + td_probe::kLenAt + s) == q.len)
      r = td_probe::keys_rank(row, s, q);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    r = max(r, __shfl_xor_sync(0xFFFFFFFFu, r, o));
  if (s == 0 && i < P) __stcs(out + i, r);"""),
        ("(P + kThreads - 1) / kThreads",
         "(P * 8 + kThreads - 1) / kThreads")],
    "len sector only (differs)": (_STORE, """\
  __stcs(out + i, (int)td_probe::len_hits(
                      td_probe::bucket_row(rows, mask, q), q.len));"""),
    "no table read (differs)": (_STORE, """  __stcs(out + i,
         (int)(td_probe::bucket_row(rows, mask, q) - rows));"""),
}


def _windows(text: bytes, B: int, N: int):
    import torch

    d = torch.zeros((B, N), dtype=torch.uint8)
    n = torch.zeros((B,), dtype=torch.int32)
    at = 0
    for b in range(B):
        raw = text[at:at + N]
        k = len(raw.decode("utf-8", errors="ignore").encode())
        d[b, :k] = torch.frombuffer(bytearray(raw[:k]), dtype=torch.uint8)
        n[b], at = k, at + k
    return d, n


def make_inputs(path: Path, dev: str = "cuda") -> None:
    """The table and each shape's keys with the plain version's ranks,
    saved to ``path`` (see the module doc); prints each shape's
    yardsticks."""
    import torch

    import chip_smoke as cs
    from tokendagger_tpu_torch import _build
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.ops.fused import caps_for
    from tokendagger_tpu_torch.tables import build_vhash8

    _build.build_all()
    ranks = cs.standin_vocab(200_000, 0, extra=cs.multiscript(1 << 20, 4))
    rows_np, mask, _ = build_vhash8(ranks)
    rows = torch.from_numpy(rows_np).to(dev)
    shapes = {}
    d, n = _windows(cs.corpus(8 * cs.WINDOW, 3).encode(), 8, cs.WINDOW)
    d, n = d.to(dev), n.to(dev)
    keys = CP.compact_piece_keys(BP.piece_starts_bits(d, n), d, n, 349_568,
                                 packed=True)
    shapes["stream (8, 349568)"] = keys
    text = cs.multiscript(9 * cs.WINDOW, 9).encode()
    for label, B, N in (("resident", 8, cs.WINDOW),
                        ("engine", 1, cs.ENGINE_WINDOW)):
        d, n = _windows(text, B, N)
        d, n = d.to(dev), n.to(dev)
        cp, cob, _, m = PT.utf8_decode(d, n)
        stb = PT.starts_to_bytes(BP.piece_starts_chars(cp, m), cob, d, n)
        p_cap = caps_for(N)["p_cap"]
        shapes[f"{label} {(B, p_cap)}"] = CP.compact_piece_keys(stb, d, n,
                                                                p_cap)
    saved = {}
    for label, k in shapes.items():
        q = (k[2], k[3], k[4], k[5], k[1])
        want = J.vocab_probe8_plain(*q, rows, mask)
        a, b = J.vhash_ab(*q)
        h = J._mix(a, b, 0, mask)
        P = want.numel()
        n_bytes = 192 * torch.unique(h).numel() + 24 * P
        plain = cs.median_ms(lambda: J.vocab_probe8_plain(*q, rows, mask),
                             reps=5)
        gather = cs.device_ms(lambda: rows.index_select(0, h.reshape(-1)))
        live = float((q[4] > 0).float().mean())
        hit = float((want >= 0).float().mean())
        print(f"{label}: {P} pieces, live {live:.4f}, hit {hit:.4f}, bound "
              f"{cs.bound(n_bytes, 0)[0]:.5f} ms ({n_bytes} B), plain "
              f"{plain:.3f} ms a call, index_select {gather:.4f} ms",
              flush=True)
        saved[label] = tuple(x.cpu() for x in (*q, want))
    torch.save({"rows": rows_np, "mask": mask, "shapes": saved}, path)


def time_variant(name: str, path: Path, inputs: Path) -> None:
    """Times the library at ``path`` at every shape (in this process)."""
    import torch

    from chip_smoke import device_ms

    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.td_vocab_probe8.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                                    vp, ctypes.c_uint, vp, vp]
    lib.td_vocab_probe8.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    saved = torch.load(inputs, weights_only=False)
    rows = torch.from_numpy(saved["rows"]).to(dev)
    mask = saved["mask"]
    row = []
    for label, args in saved["shapes"].items():
        *q, want = (x.to(dev) for x in args)
        out = torch.empty_like(want)

        def run():
            rc = lib.td_vocab_probe8(*(x.data_ptr() for x in q), want.numel(),
                                     rows.data_ptr(), mask, out.data_ptr(),
                                     stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        same = "exact" if torch.equal(out, want) else "differs"
        row.append(f"{label} {device_ms(run):.4f} ({same})")
    print(f"{name}: " + "; ".join(row), flush=True)


def main() -> int:
    sys.path.insert(0, str(REPO))
    if len(sys.argv) == 4:
        time_variant(sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3]))
        return 0
    from tools.variants import run

    variants = VARIANTS
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        names = ["as built"] + sys.argv[2].split(",")
        variants = {n: VARIANTS[n] for n in names}

    def prepare(d: Path) -> list[str]:
        make_inputs(d / "inputs.pt")
        return [str(d / "inputs.pt")]

    return run(__file__, "probe.cu", variants, "vocab_probe8_kernel",
               prepare)


if __name__ == "__main__":
    sys.exit(main())

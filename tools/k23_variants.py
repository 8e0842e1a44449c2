"""Where K2+K3's time goes on one NVIDIA card: builds csrc/compact.cu with
parts of piece_keys_kernel switched off or its blocks laid out otherwise,
and times each build device-only at the shapes the main paths give K2+K3,
and at an edge row.

    python3 tools/k23_variants.py

Each variant is a copy of the source with one text replacement, built by
nvcc for sm_90a (its register and spill lines are printed) and timed, in
a process of its own (tools/variants.py), as chip_smoke.py times a
kernel: CUDA events around 20 launches enqueued behind a sleep kernel,
median of 5 runs. Variants that switch a part off compute wrong outputs;
they only say what that part costs. Inputs (seed 0, made once and shared
by every variant):
- stream: chip_smoke.py's eight edge windows of 1 MB (prose, ragged,
  empty, one piece, punctuation, mixed, code, digits) with K1's packed
  flags, p_cap 349,568;
- resident: eight 1 MB windows of chip_smoke.py's multi-script text with
  byte flags (K9, K1's codepoint entry, starts_to_bytes, as the general
  pipeline makes them), p_cap 349,568 (cap 3.0) and 262,144 (auto's);
- engine: one 4 MB window of that text with byte flags, p_cap 1,398,144;
- edge: the stream's windows with seven empty and one that is one piece,
  packed flags.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# name -> (text in compact.cu, its replacement at every occurrence)
VARIANTS = {
    "as built": None,
    # each tile writes at 2048 slots per tile instead of its look-back base
    "no look-back wait": ("const int base = look_back(st, t, total, epoch);",
                          "const int base = t * (kKeyTile / 4);\n"
                          "    if (lane == 0) put_status(st + t, epoch << 2 "
                          "| kIncl, base + total);"),
    "no look-ahead": ("total ? next_start<", "false ? next_start<"),
    "no byte staging": ("} else if (total) {           // the tile's bytes "
                        "and the 16 after it", "} else if (false) {"),
    "no key words": ("for (int q = 0; q < 4; ++q)\n      d[(2 + q)",
                     "for (int q = 0; q < 0; ++q)\n      d[(2 + q)"),
    "no piece stores": ("for (int k = tid; k < keep; k += kKeyThreads) {",
                        "for (int k = tid; k < 0; k += kKeyThreads) {"),
    "no fill": ("    if (from < hi) {\n      int32_t* o",
                "    if (false) {\n      int32_t* o"),
    "fill blocks of 8192 slots": ("kFillSlots = 2048;", "kFillSlots = 8192;"),
    "6 blocks per SM": ("__launch_bounds__(kKeyThreads)\npiece_keys_kernel",
                        "__launch_bounds__(kKeyThreads, 6)\n"
                        "piece_keys_kernel"),
}


def make_inputs(path: Path, dev: str = "cuda") -> None:
    """The shapes' inputs, saved to ``path`` (see the module doc)."""
    import torch

    import chip_smoke as cs
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.ops.fused import caps_for

    by, nb = cs.edge_windows(0, cs.WINDOW, dev)
    shapes = {"stream (8, 1048576) packed": (
        BP.piece_starts_bits(by, nb), by, nb, 349_568, True)}
    text = cs.multiscript(9 * cs.WINDOW, 9).encode()
    for label, B, N, caps in (("resident", 8, cs.WINDOW, (349_568, 262_144)),
                              ("engine", 1, cs.ENGINE_WINDOW,
                               (caps_for(cs.ENGINE_WINDOW)["p_cap"],))):
        d = torch.zeros((B, N), dtype=torch.uint8)
        n = torch.zeros((B,), dtype=torch.int32)
        at = 0
        for b in range(B):
            raw = text[at:at + N]
            k = len(raw.decode("utf-8", errors="ignore").encode())
            d[b, :k] = torch.frombuffer(bytearray(raw[:k]), dtype=torch.uint8)
            n[b], at = k, at + k
        d, n = d.to(dev), n.to(dev)
        cp, cob, _, m = PT.utf8_decode(d, n)
        st = BP.unpack_mask(BP.piece_starts_chars(cp.contiguous(), m,
                                                  packed_out=True))
        stb = PT.starts_to_bytes(st, cob, d, n)
        for p_cap in caps:
            shapes[f"{label} {(B, N)} byte p_cap {p_cap}"] = (
                stb.contiguous(), d, n, p_cap, False)
    nb_edge = torch.zeros_like(nb)
    nb_edge[3] = cs.WINDOW
    shapes["edge (8, 1048576) packed"] = (
        BP.piece_starts_bits(by, nb_edge), by, nb_edge, 349_568, True)
    torch.save({k: tuple(x.cpu() if hasattr(x, "cpu") else x for x in v)
                for k, v in shapes.items()}, path)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_piece_keys_status_words.argtypes = [i, i]
    lib.td_piece_keys_status_words.restype = ctypes.c_longlong
    lib.td_compact_piece_keys.argtypes = (
        [vp, i, vp, vp, i, i, i, vp, vp, vp, ctypes.c_uint, vp])
    lib.td_compact_piece_keys.restype = i
    return lib


def time_variant(name: str, path: Path, inputs: Path) -> None:
    """Times the library at ``path`` at every shape (in this process)."""
    import torch

    from chip_smoke import device_ms

    lib = load(path)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    row = []
    for label, args in torch.load(inputs).items():
        starts, d, nb, p_cap, packed = (
            x.to(dev) if hasattr(x, "to") else x for x in args)
        B, N = d.shape
        out = torch.empty((6, B, p_cap), dtype=torch.int32, device=dev)
        npc = torch.empty((B,), dtype=torch.int32, device=dev)
        status = torch.zeros(lib.td_piece_keys_status_words(B, N),
                             dtype=torch.int64, device=dev)
        epoch = [0]

        def run():
            epoch[0] += 1
            rc = lib.td_compact_piece_keys(
                starts.data_ptr(), int(packed), d.data_ptr(), nb.data_ptr(),
                B, N, p_cap, out.data_ptr(), npc.data_ptr(),
                status.data_ptr(), epoch[0], stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        row.append(f"{label} {device_ms(run):.4f}")
    print(f"{name}: " + "; ".join(row), flush=True)


def main() -> int:
    sys.path.insert(0, str(REPO))
    if len(sys.argv) == 4:
        time_variant(sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3]))
        return 0
    from tools.variants import run

    def prepare(d: Path) -> list[str]:
        make_inputs(d / "inputs.pt")
        return [str(d / "inputs.pt")]

    return run(__file__, "compact.cu", VARIANTS, "piece_keys_kernel",
               prepare)


if __name__ == "__main__":
    sys.exit(main())

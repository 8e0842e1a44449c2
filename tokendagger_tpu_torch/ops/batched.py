"""Many short complete segments per launch: (rows, width) grids.

Chat turns, per-record corpus items and the spans between special tokens
are short segments. One window pipeline each costs about 150 launches and
one synchronizing read, whatever the segment's length, so the engine
packs four or more of them into a (B, W) grid and resolves the grid in
one pass of the window stages, the counterpart of the JAX package's
``ops/batched.py``. Rows never interact: each row is decoded, split and
compacted on its own.

Each segment must be COMPLETE (it ends where its text ends), so a row
needs no safe cut: trim = the row's length and every piece is final. The
stages are those of ``engine.DeviceEngine.window_pipeline`` over the grid:

1. ``pretokenize.utf8_decode`` (kernel K9, then K4);
2. ``bitplane.piece_starts_chars`` (kernel K1's row entry: one block per
   row, the row's planes in shared memory), mapped to byte flags by
   ``starts_to_bytes``;
3. ``compact.compact_piece_keys`` on the byte flags (kernel K2+K3, with
   ``p_cap = W``: a W-byte row cannot hold more than W pieces, so there is
   no overflow route);
4. ``join.vocab_probe8`` on the pieces (the probe kernel, as in the engine);
5. ``fused.finalize_host`` (kernel K4 twice).

The reference runs plain XLA stages under ``vmap`` here, and pads every
grid to ``grid_rows(W)`` rows so that XLA compiles few shapes. The
kernels take any row count, so a grid here holds at most ``grid_rows(W)``
rows, the segments it was given. Misses and oversize pieces come back as
SENTINEL slots that the caller splices exactly on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitplane import piece_starts_chars
from .compact import compact_piece_keys
from .fused import finalize_host
from .join import vocab_probe8
from .pretokenize import starts_to_bytes, utf8_decode

# row widths a segment is bucketed into (the smallest that holds it), and
# the bytes of one grid: grid_rows(256) = 4096 rows
ROW_WIDTHS = (256, 1024, 4096)
MAX_GRID_BYTES = 1 << 20


def grid_rows(width: int) -> int:
    """Rows of a full grid of ``width``-byte rows."""
    return max(1, MAX_GRID_BYTES // width)


def resolve_grid(buf: np.ndarray, lens: np.ndarray, *,
                 vhash_rows: torch.Tensor, vhash_mask: int,
                 profile: str = "llama4"):
    """Resolve B complete segments held in a (B, W) grid.

    ``buf`` (B, W) uint8 rows, 0-padded; ``lens`` (B,) row byte lengths;
    ``vhash_rows`` the engine's vhash8 table on the device the grid runs
    on. Returns numpy (flat (B, k) int32 with SENTINEL at miss slots, k
    the largest row total; total (B,); ms_start and ms_len (B, W), or
    (B, 0) when no row missed; n_ms (B,)): the contract of the JAX
    ``resolve_grid``, after one synchronizing read of the small arrays."""
    B, W = buf.shape
    dev = vhash_rows.device
    data = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8)).to(dev)
    nb = torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(dev)
    cp, cob, _boc, m = utf8_decode(data, nb)
    starts = piece_starts_chars(cp, m, profile=profile)
    stb = starts_to_bytes(starts, cob, data, nb)
    sb, pl, k0, k1, k2, k3, npc = compact_piece_keys(stb, data, nb, W)
    rank = vocab_probe8(k0, k1, k2, k3, pl, vhash_rows, vhash_mask)
    flat, total, _np, _nk, _cons, _ovf, ms_s, ms_l, n_ms = finalize_host(
        sb, pl, rank, npc, nb, p_cap=W)
    # the one synchronizing read of the small arrays, then the id grid
    # sliced to the widest row actually produced
    total_np, n_ms_np = torch.stack([total, n_ms]).cpu().numpy()
    k = int(total_np.max()) if B else 0
    flat_np = (flat[:, :k].cpu().numpy() if k
               else np.zeros((B, 0), np.int32))
    if B and int(n_ms_np.max()):
        ms_s_np, ms_l_np = torch.stack([ms_s, ms_l]).cpu().numpy()
    else:
        ms_s_np = ms_l_np = np.zeros((B, 0), np.int32)
    return flat_np, total_np, ms_s_np, ms_l_np, n_ms_np

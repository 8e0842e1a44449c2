r"""Byte-stream sharding with halo reconciliation (sequence parallelism):
the JAX package's ``parallel/sharded_text.py`` on ``torch.distributed``.

One text is split across the mesh as contiguous byte shards of
``shard_bytes``, each read with a right halo of the next shard's first
``halo`` bytes:

* **Match lengths are forward-only**: len[i] depends only on text[i:],
  so every shard computes its lengths over its bytes + halo.
* **Only the chain of piece starts is sequential**: shard d needs its
  *entry* (where the last piece of shard d-1 ended inside d's region).
  The entries are resolved in D-1 rounds of one int32 scalar from rank
  i to rank i+1; each round is one ``all_gather`` of the scalar, of
  which rank r+1 keeps rank r's (the JAX ``ppermute``; one code path for
  NCCL and gloo, on card and CPU tensors).
* Pieces starting inside a shard's own region belong to it, even when
  their bytes reach into the halo; the merge then runs shard-locally
  (``ops/merge.merge_rows``: the CUDA kernel on a card).

SPMD: every rank calls ``encode`` with the same bytes and computes only
its own shard of each pass; one ``all_gather`` of a packed int32 tensor
per pass (flat ids, total, overflow, consumed end, the oversize spans and
count, the piece bytes) gives every rank every shard's outputs, read to
the host once, so every rank returns the same ids, as the JAX single
controller does.

Exactness guards (as the JAX package's):

* **Safe-cut guard** (``overflow``: the pass is abandoned to
  ``DeviceEngine.encode_stream`` from its start): a kept piece may not
  end past the start of the character-class run touching the shard
  buffer's end (minus ``CUT_SLACK``) unless the buffer ends at the true
  end of the text.
* **Oversize pieces** (wider than ``MERGE_WIDTH``) take the ``SENTINEL``
  id in the flat stream plus their (start, len); the host splices them
  with the engine's ``splice.Splicer`` (a whole-piece lookup, then the
  merge). Only more than ``OVERSIZE_CAP`` of them in one shard overflow.
* The device merge is merge-only (no whole-piece lookup), which equals
  tiktoken's lookup-then-merge only for a merge-reachable vocabulary, so
  the encoder requires one (``DeviceEngine.all_reachable``).

The JAX body maps one to one: ``jnp.searchsorted`` ->
``torch.searchsorted``, ``.at[jump].max`` -> an int32
``scatter_reduce_`` amax, ``.at[tgt].set(mode="drop")`` -> a scatter
into one extra slot that is sliced off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import CUT_SLACK
from ..ops.fused import SENTINEL
from ..ops.merge import merge_rows
from ..ops.pretokenize import _cls_lookup, match_lengths, utf8_decode
from ..unicode_tables import LC, LETTER, NUM, UC, WS, get_two_level_tables
from ..vocab import refuse_kimi
from .mesh import Mesh, all_gather

MERGE_WIDTH = 64     # per-piece merge row width in the sharded body
OVERSIZE_CAP = 256   # max host-spliced oversize pieces per shard per pass

# the per-shard scalars of the packed pass outputs, after the flat ids
_SCALARS = ("total", "overflow", "consumed_end")


def _scatter_drop(n: int, tgt: torch.Tensor, vals: torch.Tensor,
                  fill: int = 0) -> torch.Tensor:
    """(n,) tensor of ``vals``' dtype holding vals[i] at tgt[i] where
    tgt[i] < n (``tgt`` == n drops the value): ``.at[tgt].set(vals,
    mode="drop")`` on a ``fill`` array."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_(0, tgt, vals)[:n]


class _Shard:
    """One rank's pass body (the JAX ``_local_tokenize``) with its tables
    on the mesh's device."""

    def __init__(self, eng, mesh: Mesh, W: int, H: int):
        dev = mesh.device
        mt = eng.merge_tables()
        self.mesh, self.W, self.H = mesh, W, H
        self.byte_rank = mt.byte_rank.to(dev)
        self.pair_rows = mt.pair_rows.to(dev)
        self.mask = mt.pair_mask
        self.profile = eng._profile
        self.page_ids, self.pages = (
            torch.from_numpy(a.astype(np.int64)).to(dev)
            for a in get_two_level_tables())

    def run(self, buf: torch.Tensor, nlocal: int, true_eos: bool,
            trim_after: int) -> torch.Tensor:
        """This shard's outputs packed into one int32 tensor:
        [flat (W+H), total, overflow, consumed_end, os_start
        (OVERSIZE_CAP), os_len (OVERSIZE_CAP), n_wide, piece bytes]."""
        W, H, mesh = self.W, self.H, self.mesh
        WH = W + H
        dev = buf.device
        i32 = torch.int32
        idx = torch.arange(WH, device=dev)

        cp, _, boc, m = utf8_decode(buf, nlocal)
        lens = match_lengths(cp, m, self.page_ids, self.pages,
                             profile=self.profile)

        # char-level jump array with doubling tables
        nxt = torch.clamp(idx + torch.clamp(lens.to(torch.int64), min=1),
                          max=WH)
        nxt = torch.cat([nxt, torch.full((1,), WH, device=dev)])
        levels = [nxt]
        n_levels = max(1, int(np.ceil(np.log2(WH))))
        for _ in range(n_levels):
            levels.append(levels[-1][levels[-1]])

        # boc: char -> byte offset, padded with nlocal; the first char of
        # the next shard's region
        W_char = torch.searchsorted(boc, torch.tensor(W, dtype=i32,
                                                      device=dev))

        def exit_from(entry_char):
            """First chain position (char) at/after W_char, following
            from entry_char, as a byte offset inside the next shard."""
            pos = entry_char
            for lvl in reversed(levels):
                cand = lvl[pos.clamp(0, WH)]
                pos = torch.where(cand < W_char, cand, pos)
            nxt_pos = levels[0][pos.clamp(0, WH)]
            exit_char = torch.where(entry_char >= W_char, entry_char,
                                    nxt_pos)
            exit_byte = torch.where(exit_char < WH,
                                    boc[exit_char.clamp(0, WH - 1)], nlocal)
            return exit_byte - W

        # entry handoff: D-1 rounds of one scalar from rank r to rank r+1
        me = mesh.rank
        entry_byte = torch.tensor(0 if me == 0 else -1, dtype=i32,
                                  device=dev)                # -1: unknown
        for r in range(mesh.size - 1):
            entry_char = torch.searchsorted(boc, entry_byte.clamp(min=0))
            ex = torch.where(entry_byte >= 0, exit_from(entry_char), -1)
            got = all_gather(ex.to(i32).reshape(1), mesh)
            if me == r + 1:
                entry_byte = torch.where(entry_byte < 0, got[r, 0],
                                         entry_byte)
        entry_byte = entry_byte.clamp(min=0)
        entry_char = torch.searchsorted(boc, entry_byte)

        # piece starts reachable from the entry
        reach = torch.zeros(WH + 1, dtype=i32, device=dev)
        reach[entry_char] = 1
        jump = levels[0]
        for _ in range(n_levels + 1):
            hit = torch.zeros_like(reach).scatter_reduce_(0, jump, reach,
                                                          reduce="amax")
            reach = reach | hit
            jump = jump[jump]
        starts = (reach[:WH] != 0) & (idx < m)

        start_byte = boc
        keep = starts & (start_byte < min(W, nlocal))
        piece_len_chars = torch.where(keep, lens, 0)
        end_char = torch.clamp(idx + piece_len_chars, max=WH - 1)
        end_byte = torch.where(keep, boc[end_char], 0)
        end_byte = torch.where(keep & (idx + piece_len_chars >= m), nlocal,
                               end_byte)
        # multi-pass continuation: drop pieces past the safe cut (they are
        # scanned again at the start of the next pass)
        keep = keep & (end_byte <= trim_after)
        end_byte = torch.where(keep, end_byte, 0)
        piece_bytes = torch.where(keep, end_byte - start_byte, 0)
        consumed_end = end_byte.max()

        # safe-cut guard: the start of the coarse class run touching the
        # end of valid data (engine._safe_cut_threshold's analysis)
        cls = _cls_lookup(cp, self.page_ids, self.pages)
        c_ws = (cls & WS) != 0
        c_wd = (cls & (UC | LC | LETTER)) != 0
        c_num = ((cls & NUM) != 0) & ~c_wd
        co = torch.where(c_ws, 0, torch.where(c_num, 1,
                                              torch.where(c_wd, 2, 3)))
        last_co = co[(m.to(torch.int64) - 1).clamp(0, WH - 1)]
        diffpos = torch.where((idx < m) & (co != last_co), idx, -1).max()
        run_start_byte = boc[(diffpos + 1).clamp(0, WH - 1)]
        overflow = (keep & (end_byte > run_start_byte - CUT_SLACK)).any() \
            & (not true_eos)

        # compact the pieces (at most W: each starts in [0, W))
        R = W
        pid = torch.cumsum(keep.to(i32), 0) - 1
        tgt = torch.where(keep, pid.clamp(max=R - 1), R).long()
        s_arr = _scatter_drop(R, tgt, torch.where(keep, start_byte, 0))
        l_arr = _scatter_drop(R, tgt, piece_bytes.to(i32))

        # oversize pieces: merged on the host, spliced in at a sentinel
        wide = l_arr > MERGE_WIDTH
        n_wide = wide.sum(dtype=i32)
        overflow = overflow | (n_wide > OVERSIZE_CAP)
        wpid = torch.cumsum(wide.to(i32), 0) - 1
        wtgt = torch.where(wide, wpid.clamp(max=OVERSIZE_CAP - 1),
                           OVERSIZE_CAP).long()
        os_start = _scatter_drop(OVERSIZE_CAP, wtgt,
                                 torch.where(wide, s_arr, 0))
        os_len = _scatter_drop(OVERSIZE_CAP, wtgt, torch.where(wide, l_arr, 0))

        l_merge = torch.where(wide, 0, l_arr)
        cols = torch.arange(MERGE_WIDTH, device=dev)[None, :]
        gidx = (s_arr[:, None] + cols).clamp(0, WH - 1)
        rows_buf = torch.where(cols < l_merge[:, None], buf[gidx], 0)
        tok, counts = merge_rows(rows_buf.contiguous(), l_merge.contiguous(),
                                 self.byte_rank, self.pair_rows, self.mask)
        counts = torch.where(wide, 1, counts)
        tok[:, 0] = torch.where(wide, SENTINEL, tok[:, 0])

        # flatten the shard's tokens
        live = tok >= 0
        out_pos = torch.cumsum(counts, 0) - counts
        col_rank = torch.cumsum(live.to(i32), 1) - 1
        flat_idx = torch.where(live, out_pos[:, None] + col_rank, WH).long()
        flat = _scatter_drop(WH, flat_idx.reshape(-1), tok.reshape(-1), -1)
        return torch.cat([
            flat,
            torch.stack([counts.sum(dtype=i32), overflow.to(i32),
                         consumed_end.to(i32)]),
            os_start, os_len,
            torch.stack([n_wide, piece_bytes.sum(dtype=i32)]),
        ])


class ShardedTextEncoder:
    """Encode one byte stream data-parallel across a mesh with exact
    halo-reconciled boundaries: the JAX ``ShardedTextEncoder`` over the
    port's ``DeviceEngine`` and ``parallel.mesh.Mesh``. Every rank of the
    mesh calls ``encode`` with the same bytes and gets the same ids.
    Falls back to ``DeviceEngine.encode_stream`` whenever an exactness
    guard trips (counted in ``fallbacks``; ``passes`` counts the mesh
    passes attempted)."""

    def __init__(self, device_engine, mesh: Mesh, *,
                 shard_bytes: int = 1 << 17, halo: int = 1 << 14):
        refuse_kimi("ShardedTextEncoder", profile=device_engine._profile)
        if not device_engine.stream:
            raise ValueError(
                "ShardedTextEncoder requires a stream-capable DeviceEngine "
                "(supported pattern profile, no rank-less bytes)")
        if not device_engine.all_reachable():
            # the sharded body is merge-only (no whole-piece join), which
            # matches tiktoken's lookup-then-merge only for reachable vocabs
            raise ValueError(
                "ShardedTextEncoder requires a merge-reachable vocab")
        self.eng = device_engine
        self.mesh = mesh
        self.D = mesh.size
        self.W = shard_bytes
        self.H = halo
        self.passes = 0     # mesh passes attempted
        self.fallbacks = 0  # passes abandoned to the single-device path
        self._shard = _Shard(device_engine, mesh, shard_bytes, halo)

    def pass_outputs(self, data: bytes, final: bool) -> dict | None:
        """Run one pass over up to D*W bytes on every rank: each shard's
        outputs as numpy arrays with a leading (D,) axis (``flat``,
        ``total``, ``overflow``, ``consumed_end``, ``os_start``,
        ``os_len``, ``n_wide``) and the mesh-summed ``total_bytes``; None
        when a continuing pass's last shard has no safe cut."""
        D, W, H = self.D, self.W, self.H
        n = len(data)
        lo = np.arange(D) * W
        nloc = np.clip(np.minimum(n, lo + W + H) - lo, 0, None).astype(
            np.int64)
        last = min((n - 1) // W, D - 1)
        # a shard's buffer may end exactly at the true end of the text (its
        # halo absorbs the tail): then its false-EOS guard must not fire
        trim = 1 << 30
        if final:
            true_eos = bool(nloc[self.mesh.rank] > 0
                            and lo[self.mesh.rank] + nloc[self.mesh.rank]
                            == n)
        else:
            true_eos = False
            # the stream continues past this pass: the last shard's tail is
            # a false end-of-text; trim at its safe cut and resume there
            # (every rank computes it: it is deterministic)
            rs = self.eng._safe_cut_threshold(
                data[lo[last] : lo[last] + nloc[last]])
            if rs <= 0:
                return None  # a single run spans the shard: fall back
            if self.mesh.rank == last:
                trim = rs
        me = self.mesh.rank
        buf = np.zeros(W + H, dtype=np.uint8)
        mine = np.frombuffer(data[lo[me] : lo[me] + nloc[me]], np.uint8)
        buf[: len(mine)] = mine
        packed = self._shard.run(
            torch.from_numpy(buf).to(self.mesh.device), int(nloc[me]),
            true_eos, trim)
        g = all_gather(packed, self.mesh).cpu().numpy()  # the one read
        WH, C = W + H, OVERSIZE_CAP
        out = {"flat": g[:, :WH]}
        for j, k in enumerate(_SCALARS):
            out[k] = g[:, WH + j]
        base = WH + len(_SCALARS)
        out["overflow"] = out["overflow"].astype(bool)
        out["os_start"] = g[:, base : base + C]
        out["os_len"] = g[:, base + C : base + 2 * C]
        out["n_wide"] = g[:, base + 2 * C]
        out["total_bytes"] = int(g[:, base + 2 * C + 1].sum())
        return out

    def _one_pass(self, data: bytes, final: bool):
        """Tokenize up to D*W bytes; returns (ids or None on overflow,
        consumed_bytes)."""
        o = self.pass_outputs(data, final)
        if o is None or o["overflow"].any():
            return None, 0
        W = self.W
        shard_ids = []
        for d in range(self.D):
            sf = o["flat"][d, : o["total"][d]]
            if o["n_wide"][d]:
                # the shard's spans, offset by its base, in the pass's bytes
                sf = self.eng._splicer.splice(
                    sf, data, o["os_start"][d] + d * W, o["os_len"][d],
                    int(o["n_wide"][d]))[0]
            shard_ids.append(sf)
        ids = np.concatenate(shard_ids).astype(np.int64)
        if final:
            return ids, len(data)
        # resume point = global end of the last emitted piece (pieces are
        # contiguous, so this is the max over shards; a shard whose pieces
        # overhang into the next shard's region can exceed that shard's own
        # start when the next shard kept nothing)
        consumed = int(max(d * W + int(o["consumed_end"][d])
                           for d in range(self.D)))
        if consumed <= 0:
            return None, 0
        return ids, consumed

    def encode(self, data: bytes) -> np.ndarray:
        D, W = self.D, self.W
        n = len(data)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        out: list[np.ndarray] = []
        base = 0
        while base < n:
            final = (n - base) <= D * W
            self.passes += 1
            ids, consumed = self._one_pass(data[base : base + D * W], final)
            if ids is None:
                # exactness guard tripped: windowed device path from here
                self.fallbacks += 1
                out.append(self.eng.encode_stream(data[base:]))
                break
            out.append(ids)
            base += consumed
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)

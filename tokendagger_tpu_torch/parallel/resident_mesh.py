"""The window-batch pipeline with its windows sharded over a mesh: the
JAX package's ``parallel/resident_mesh.py`` on ``torch.distributed``.

Each rank runs the fixed-shape stages of ``resident.batch_pipeline``
(UTF-8 decode, piece starts, piece keys, whole-piece probe, finalize)
over ITS rows of the window batch, and the token and byte counters are
summed over the mesh (``all_reduce``); tables are replicated. Nothing
else crosses ranks. The JAX names map so:

* the jitted ``shard_map`` returned with its input shardings ->
  a function over this rank's (b_local, N) windows and (b_local,)
  lengths, which ``mesh.shard_rows`` cuts out of the global batch (the
  counterpart of ``jax.device_put(x, shardings[i])``);
* ``piece_starts_bits_pallas`` -> ``bitplane.piece_starts_bits`` (bytes)
  and ``piece_starts_chars`` (codepoints, or the hot-codepoint classes
  through its class-word entry); ``compact_piece_keys_butterfly`` ->
  ``compact.compact_piece_keys``; ``finalize_butterfly`` ->
  ``compact.finalize``;
* ``vocab_probe8t_chunks`` and its chunk-count heuristic (a TPU gather
  workaround) -> the one probe ``join.vocab_probe8``; ``vocab_probe_hot``
  -> ``join.vocab_probe_hot``;
* ``interpret=True`` -> CPU tensors, which run every kernel's plain
  version.
"""

from __future__ import annotations

import torch

from ..resident import batch_pipeline
from ..vocab import refuse_kimi
from .mesh import Mesh, all_sum


def mesh_resident_pipeline(
    mesh: Mesh,
    tables,
    page_ids,
    pages,
    *,
    window: int,
    p_cap: int,
    impl: str = "ascii",
    profile: str = "llama4",
    c_cap: int | None = None,
    class_hot_cfg: dict | None = None,
    probe_hot_cfg: dict | None = None,
):
    """Build ``fn(windows (b_local, N) uint8, nbytes (b_local,) int32) ->
    (flat_ids, n_kept, n_pieces, n_kept, consumed, overflow, miss_start,
    miss_len, n_miss, total_tokens, total_bytes)`` over this rank's rows
    (``mesh.shard_rows``) on ``mesh.device``: the nine per-window outputs of
    ``compact.finalize`` and the two int32 counters summed over the mesh
    (the same on every rank).

    ``tables`` holds ``vhash8_rows``/``vhash8_mask`` (``convert.
    tables_from_ranks``); ``page_ids``/``pages`` are the JAX signature's
    class pages, which the port's K1 does not read (it carries its class
    tables, ``bitplane.class_lut``). As in the JAX package:

    * impl="ascii": every window pure ASCII (the caller guarantees it);
      K1's byte entry, its plane words fed packed to K2+K3 exactly when
      ``window == 1 << 20``;
    * impl="general": any UTF-8; ``c_cap`` char slots (default
      ``window``, a multiple of 4096);
    * class_hot_cfg {hot_cps, u_cap} (impl "general", c_cap % 32768 ==
      0) and probe_hot_cfg {hot_keys, hot_ranks, u_cap} (p_cap padded to
      a multiple of 32768): the hot routes, whose u_cap overflows fold
      into the per-window overflow flag."""
    del page_ids, pages
    refuse_kimi("mesh_resident_pipeline", profile=profile)
    if impl not in ("ascii", "general"):
        raise ValueError(f"impl must be 'ascii' or 'general', got {impl!r}")
    cc = c_cap or window
    if cc % 4096:
        raise ValueError(f"c_cap {cc} is not a multiple of 4096")
    if probe_hot_cfg is not None:
        # the hot probe's compaction tiles need p_cap % 32768 == 0
        p_cap = max(32768, -(-p_cap // 32768) * 32768)
    if class_hot_cfg is not None and (impl != "general" or cc % 32768):
        raise ValueError("class_hot_cfg needs impl='general' and "
                         "c_cap % 32768 == 0")
    rows = tables.vhash8_rows.to(mesh.device)
    vmask = tables.vhash8_mask
    packed = impl == "ascii" and window == 1 << 20
    hot = class_hot_cfg or {}

    def fn(windows: torch.Tensor, nbytes: torch.Tensor):
        out = batch_pipeline(
            windows, nbytes, impl=impl, p_cap=p_cap, rows=rows, vmask=vmask,
            profile=profile, c_cap=cc, packed=packed,
            hot_cps=(tuple(hot["hot_cps"]) if hot else None),
            u_cap=hot.get("u_cap"), probe_hot_cfg=probe_hot_cfg)
        local = torch.stack([out[1].sum(dtype=torch.int32),
                             nbytes.sum(dtype=torch.int32)])
        total = all_sum(local, mesh.group)
        return out + (total[0], total[1])

    return fn

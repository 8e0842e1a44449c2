"""The device tables, built from ranks or converted from the JAX package's
state.

``StreamTables`` is what ``ResidentStream`` keeps on the device: the
``vhash8`` whole-piece table. ``EngineTables`` is what ``DeviceEngine``
and ``Tokenizer`` keep: the same table plus the rank -> bytes decode
tables, which ``decode_tables_from_ranks`` also builds alone.
``MergeTables`` is what the device BPE merge reads (``ops/merge.py``,
``ops/fused.resolve_window``): the byte ranks, the pair-merge hash table,
the byte-pair ranks and the whole-piece join keys of ``ops/join.vocab_join``;
``DeviceEngine`` builds it at its first piece-path call or first window
that needs it.
``tables_from_reference`` and ``engine_tables_from_reference`` (and
``merge_tables_from_reference``) take the JAX package's arrays as numpy (the fields of
``tables.build_tables(...)``, and ``unicode_tables.get_tables()``) and
return them as the port's tensors. The class table must be the one this
package ships (``data/unicode_classes.npz``): its kernels classify bytes
with it, so a different table is refused rather than silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class StreamTables:
    vhash8_rows: torch.Tensor   # (nb, 48) int32 on the stream's device
    vhash8_mask: int
    vhash8_dropped: int = 0


def tables_from_ranks(ranks: dict[bytes, int], *,
                      device: str | torch.device) -> StreamTables:
    from .tables import build_vhash8

    rows, mask, dropped = build_vhash8(ranks)
    return StreamTables(torch.as_tensor(rows, device=device), mask, dropped)


@dataclass
class EngineTables:
    vhash8_rows: torch.Tensor     # (nb, 48) int32
    vhash8_mask: int
    decode_offsets: torch.Tensor  # (V,) int64 rank -> blob offset
    decode_lengths: torch.Tensor  # (V,) int32 byte length, -1 unknown id
    decode_blob: torch.Tensor     # (L,) uint8 concatenated token bytes
    n_vocab: int
    vhash8_dropped: int = 0


def decode_tables_from_ranks(ranks: dict[bytes, int],
                             specials: dict[str, int], *,
                             device: str | torch.device):
    """The rank -> bytes tables alone, which do not depend on the split
    pattern: (offsets, lengths, blob) tensors on ``device`` and n_vocab,
    as ``EngineTables`` holds them."""
    from .tables import build_decode_tables

    offs, lens, blob, n_vocab = build_decode_tables(ranks, specials)
    return (torch.as_tensor(offs, device=device),
            torch.as_tensor(lens, device=device),
            torch.as_tensor(blob, device=device), n_vocab)


def engine_tables_from_ranks(ranks: dict[bytes, int],
                             specials: dict[str, int], *,
                             device: str | torch.device,
                             decode=None) -> EngineTables:
    """``EngineTables`` on ``device``; ``decode``, the tuple of
    ``decode_tables_from_ranks`` for the same vocabulary, is reused rather
    than built again."""
    from .tables import build_vhash8

    rows, mask, dropped = build_vhash8(ranks)
    if decode is None:
        decode = decode_tables_from_ranks(ranks, specials, device=device)
    return EngineTables(torch.as_tensor(rows, device=device), mask, *decode,
                        vhash8_dropped=dropped)


def _rows(vhash8_rows: np.ndarray, vhash8_mask: int) -> np.ndarray:
    rows = np.ascontiguousarray(vhash8_rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[1] != 48:
        raise ValueError("vhash8_rows must be (nb, 48)")
    if int(vhash8_mask) != rows.shape[0] - 1:
        raise ValueError("vhash8_mask must be the bucket count minus one")
    return rows


def engine_tables_from_reference(vhash8_rows: np.ndarray, vhash8_mask: int,
                                 decode_offsets: np.ndarray,
                                 decode_lengths: np.ndarray,
                                 decode_blob: np.ndarray, n_vocab: int, *,
                                 device: str | torch.device) -> EngineTables:
    """The JAX package's ``build_tables(ranks, specials)`` fields (numpy)
    as the port's ``EngineTables`` on ``device``."""
    rows = _rows(vhash8_rows, vhash8_mask)
    offs = np.ascontiguousarray(decode_offsets, dtype=np.int64)
    lens = np.ascontiguousarray(decode_lengths, dtype=np.int32)
    blob = np.ascontiguousarray(decode_blob, dtype=np.uint8)
    if offs.shape != (n_vocab,) or lens.shape != (n_vocab,):
        raise ValueError("decode tables must hold n_vocab entries")
    if int((offs + np.maximum(lens, 0)).max(initial=0)) > len(blob):
        raise ValueError("decode offsets run past the blob")
    return EngineTables(
        torch.as_tensor(rows, device=device), int(vhash8_mask),
        torch.as_tensor(offs, device=device),
        torch.as_tensor(lens, device=device),
        torch.as_tensor(blob, device=device), int(n_vocab))


def tables_from_reference(vhash8_rows: np.ndarray, vhash8_mask: int,
                          classes: np.ndarray, folds: dict, *,
                          device: str | torch.device) -> StreamTables:
    """The JAX package's vhash8 table and class tables as the port's."""
    from .unicode_tables import get_tables

    own_classes, own_folds = get_tables()
    same = np.array_equal(np.asarray(classes), own_classes) and set(
        folds) == set(own_folds) and all(
        np.array_equal(np.asarray(folds[k]), own_folds[k]) for k in own_folds)
    if not same:
        raise ValueError("class tables differ from the port's shipped table")
    rows = _rows(vhash8_rows, vhash8_mask)
    return StreamTables(torch.as_tensor(rows, device=device),
                        int(vhash8_mask))


@dataclass
class MergeTables:
    byte_rank: torch.Tensor   # (256,) int32, -1 for a byte without a rank
    pair_rows: torch.Tensor   # (nb, 12) int32 pair-merge hash rows
    pair_mask: int            # nb - 1
    pair_lut: torch.Tensor    # (256, 256) int32 2-byte token ranks, MAX
    vk: torch.Tensor          # (V, 4) int32 key words (uint32 bits)
    vlen: torch.Tensor        # (V,) int32 token byte lengths
    vrank: torch.Tensor       # (V,) int32 token ranks


def merge_tables_from_ranks(ranks: dict[bytes, int], *,
                            device: str | torch.device) -> MergeTables:
    """``MergeTables`` of a mergeable-ranks dict on ``device``."""
    from .tables import build_pair_table, byte_rank, pair_lut, vocab_keys

    pair = build_pair_table(ranks)
    vk, vlen, vrank = vocab_keys(ranks)
    return merge_tables_from_reference(
        byte_rank(ranks), pair.rows, pair.mask, pair_lut(ranks), vk, vlen,
        vrank, device=device)


def merge_tables_from_reference(byte_rank: np.ndarray, pair_rows: np.ndarray,
                                pair_mask: int, pair_lut: np.ndarray,
                                vocab_keys: np.ndarray, vocab_lens: np.ndarray,
                                vocab_ranks: np.ndarray, *,
                                device: str | torch.device) -> MergeTables:
    """The JAX package's ``build_tables`` fields (``byte_rank``,
    ``pair.rows``, ``pair.mask``, ``pair_lut``, ``vocab_keys``,
    ``vocab_lens``, ``vocab_ranks``; numpy) as the port's ``MergeTables``
    on ``device``."""
    br = np.ascontiguousarray(byte_rank, dtype=np.int32)
    rows = np.ascontiguousarray(pair_rows, dtype=np.int32)
    lut = np.ascontiguousarray(pair_lut, dtype=np.int32)
    vk = np.ascontiguousarray(vocab_keys).view(np.int32)
    vlen = np.ascontiguousarray(vocab_lens, dtype=np.int32)
    vrank = np.ascontiguousarray(vocab_ranks, dtype=np.int32)
    if br.shape != (256,) or lut.shape != (256, 256):
        raise ValueError("byte_rank must be (256,) and pair_lut (256, 256)")
    if rows.ndim != 2 or rows.shape[1] != 12:
        raise ValueError("pair_rows must be (nb, 12)")
    if int(pair_mask) != rows.shape[0] - 1 or rows.shape[0] & int(pair_mask):
        raise ValueError("pair_mask must be the bucket count (a power of "
                         "two) minus one")
    V = vlen.shape[0]
    if vk.shape != (V, 4) or vrank.shape != (V,):
        raise ValueError("vocab_keys must be (V, 4) 32-bit words beside "
                         "(V,) lengths and ranks")

    def t(a):
        return torch.as_tensor(a, device=device)

    return MergeTables(t(br), t(rows), int(pair_mask), t(lut), t(vk),
                       t(vlen), t(vrank))

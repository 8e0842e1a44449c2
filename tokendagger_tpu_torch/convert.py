"""The device tables, built from ranks or converted from the JAX package's
state.

``StreamTables`` is what ``ResidentStream`` keeps on the device: the
``vhash8`` whole-piece table. ``EngineTables`` is what ``DeviceEngine``
and ``Tokenizer`` keep: the same table plus the rank -> bytes decode
tables. ``tables_from_reference`` and ``engine_tables_from_reference``
take the JAX package's arrays as numpy (the fields of
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


def engine_tables_from_ranks(ranks: dict[bytes, int],
                             specials: dict[str, int], *,
                             device: str | torch.device) -> EngineTables:
    from .tables import build_decode_tables, build_vhash8

    rows, mask, dropped = build_vhash8(ranks)
    t = engine_tables_from_reference(
        rows, mask, *build_decode_tables(ranks, specials), device=device)
    t.vhash8_dropped = dropped
    return t


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

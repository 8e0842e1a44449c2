"""The stream's device tables, built from ranks or converted from the JAX
package's state.

``StreamTables`` is what ``ResidentStream`` keeps on the device: the
``vhash8`` whole-piece table. ``tables_from_reference`` takes the JAX
package's arrays as numpy (``tables.build_tables(...).vhash8_rows`` /
``.vhash8_mask`` and ``unicode_tables.get_tables()``) and returns them as
the port's tensors. The class table must be the one this package ships
(``data/unicode_classes.npz``): its kernels classify bytes with it, so a
different table is refused rather than silently ignored.
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
    rows = np.ascontiguousarray(vhash8_rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[1] != 48:
        raise ValueError("vhash8_rows must be (nb, 48)")
    if int(vhash8_mask) != rows.shape[0] - 1:
        raise ValueError("vhash8_mask must be the bucket count minus one")
    return StreamTables(torch.as_tensor(rows, device=device),
                        int(vhash8_mask))

"""The host splice of the pieces a device pipeline missed.

Every device pipeline of the port (``DeviceEngine``'s windows and grids,
``ResidentStream``, ``run_resident``'s check, ``ShardedTextEncoder``)
leaves a ``SENTINEL`` slot in its flat ids for each piece it could not
resolve, and the piece's (start, length) in piece order. ``Splicer``
replaces each slot with the piece's exact ids, as the host engine
resolves a piece (``HostEngine.encode_ordinary``): its whole-piece rank
first, else ``byte_pair_merge``.

Its native route is one ``td_splice`` call a window (``native.
NativeSplicer``: the whole-piece hash, the thread's memo, then the exact
merge; from 1,024 misses on, on up to 8 threads). The Python loop below
is its plain version: it serves where the native table cannot be built
(no C++ toolchain, or a vocabulary it refuses) and, from then on, where
``td_splice`` met a byte without a rank. Both count the misses found
whole in the vocabulary and those whose first code point is Han.
"""

from __future__ import annotations

import numpy as np

from . import native
from .hostengine import byte_pair_merge
from .ops.fused import SENTINEL
from .unicode_tables import han_plane


class Splicer:
    """The splice of missed pieces over ``ranks`` (bytes -> id): the
    native route where it builds, else the Python loop. Thread-safe."""

    def __init__(self, ranks: dict[bytes, int]):
        self.ranks = ranks
        byte_rank = np.asarray([ranks.get(bytes([b]), -1) for b in range(256)],
                               np.int32)
        try:
            self.native = native.NativeSplicer(ranks, byte_rank)
        except RuntimeError:  # no toolchain, or a vocabulary it refuses
            self.native = None

    def splice(self, ids: np.ndarray, data: bytes, ms_s: np.ndarray,
               ms_l: np.ndarray, n_ms: int):
        """(int64 ids with each ``SENTINEL`` replaced by the ids of its
        miss, the misses found whole, the misses whose first code point is
        Han, True where the native route spliced): ``ids`` in piece order,
        miss j the piece ``data[ms_s[j] : ms_s[j] + ms_l[j]]``.
        RuntimeError where the sentinels are not ``n_ms``."""
        nat = self.native
        if nat is not None:
            got = nat.splice(ids, data, ms_s, ms_l, n_ms, SENTINEL)
            if not isinstance(got, int):
                return (*got, True)
            if got == native.SPLICE_RANKLESS:
                self.native = None  # its byte table has a hole
        sent_pos = np.flatnonzero(ids == SENTINEL)
        if len(sent_pos) != n_ms:
            raise RuntimeError(f"{len(sent_pos)} SENTINEL slots for "
                               f"{n_ms} missed pieces")
        parts = []
        prev = 0
        whole = han = 0
        is_han = han_plane()
        for j, p in enumerate(sent_pos):
            parts.append(ids[prev:p])
            piece = data[int(ms_s[j]) : int(ms_s[j]) + int(ms_l[j])]
            first = piece[:4].decode("utf-8", "ignore")[:1]
            if first and is_han[ord(first)]:
                han += 1
            # whole-piece lookup FIRST, like the oracle (hostengine
            # encode_ordinary): a probe miss on device may be a deliberate
            # false miss (token dropped from the device hash table), and
            # merge(piece) == [rank] is a vocab property, not a guarantee
            r = self.ranks.get(piece)
            if r is not None:
                whole += 1
            parts.append([r] if r is not None
                         else byte_pair_merge(piece, self.ranks))
            prev = p + 1
        parts.append(ids[prev:])
        out = np.concatenate([np.asarray(a, dtype=np.int64) for a in parts])
        return out, whole, han, False

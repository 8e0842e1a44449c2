"""Window-pipeline constants shared by the stages."""

from __future__ import annotations

SENTINEL = 2**31 - 2  # flat-stream marker for a piece the host splices


def caps_for(n: int, bytes_per_piece: float = 3.0) -> dict[str, int]:
    """Static capacities for a window of n bytes: piece slots and per-width
    miss-row capacities (same values as the JAX package's
    ``ops/fused.caps_for``).

    ``bytes_per_piece`` sets the piece-slot capacity; a denser window
    sets the overflow flag and takes the exact host path, so a wrong
    guess costs time, never correctness."""
    return dict(
        p_cap=max(512, -(-int(n / bytes_per_piece) // 128) * 128),
        m16=max(256, n // 16),
        m64=max(64, n // 128),
        m256=max(32, n // 1024),
        os_cap=128,
    )

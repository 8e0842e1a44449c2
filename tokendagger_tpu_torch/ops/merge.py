"""32-bit hash mixing on torch tensors.

torch has no usable uint32 arithmetic (shifts and adds raise on the CPU),
so 32-bit words ride in int64 tensors holding values in [0, 2**32), and
every product is formed from 16-bit halves so that no intermediate leaves
the int64 range."""

from __future__ import annotations

import torch

from ..tables import _MIX

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits unsigned."""
    return x.to(torch.int64) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) (int64) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _mix(a: torch.Tensor, b: torch.Tensor, which: int, mask: int) -> torch.Tensor:
    """uint32 multiply-xor mix; bit-identical to tables._mix_hash. a, b are
    any integer tensors (their low 32 bits are used); returns int64."""
    c1, c2, c3 = _MIX[which]
    h = (mul32(u32(a), c1) + mul32(u32(b), c2)) & M32
    h = h ^ (h >> 16)
    h = mul32(h, c3)
    h = h ^ (h >> 15)
    return h & mask

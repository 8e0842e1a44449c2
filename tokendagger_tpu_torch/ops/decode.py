"""Decode: token ids -> byte stream, on the device that holds the tables.

Per output byte position, a searchsorted over the running end offsets of
the tokens finds its token, and a gather reads the byte from the
rank -> bytes blob (``tables.build_decode_tables``). Plain torch: the JAX
package's ``ops/decode.decode_ids`` is plain XLA too, not a Pallas kernel.
Ids must be validated by the caller (``wrapper.Tokenizer`` does); unknown
ids are an error there, as in tiktoken.
"""

from __future__ import annotations

import torch


def decode_ids(ids: torch.Tensor, offsets: torch.Tensor,
               lengths: torch.Tensor, blob: torch.Tensor, out_size: int):
    """(N,) int token ids (pre-validated), (V,) int64 offsets and int32
    lengths, (L,) uint8 blob, all on one device -> (out (out_size,) uint8
    zero beyond the total, total 0-d int32)."""
    if ids.numel() == 0:
        return (torch.zeros(out_size, dtype=torch.uint8, device=blob.device),
                torch.zeros((), dtype=torch.int32, device=blob.device))
    ids = ids.to(torch.int64)
    lens = lengths[ids].to(torch.int64)
    ends = torch.cumsum(lens, dim=0)
    starts = ends - lens
    total = ends[-1]
    j = torch.arange(out_size, device=blob.device)
    t = torch.searchsorted(ends, j, right=True).clamp(0, ids.numel() - 1)
    src = (offsets[ids[t]] + (j - starts[t])).clamp(0, blob.numel() - 1)
    out = torch.where(j < total, blob[src], 0).to(torch.uint8)
    return out, total.to(torch.int32)

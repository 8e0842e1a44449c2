"""Meshes of ranks and the sharded tokenization steps, on
``torch.distributed``.

The JAX package's ``parallel/mesh.py`` runs one program over a
``jax.sharding.Mesh`` from a single controller: ``shard_map`` hands each
device its rows and ``psum`` reduces the counters over ICI. Here every
rank is its own process with one device (SPMD): it holds only its shard
of the rows, calls the same function as every other rank, and the
counters are reduced by ``all_reduce`` over the mesh's process group
(NCCL on cards, gloo on the CPU). The JAX names map so:

* ``get_mesh(n)`` (the first n devices) -> ``get_mesh(n)``: the first n
  ranks of the default group, one ``Mesh`` per rank;
* ``get_mesh_2d(hosts, chips)`` -> the same, with a "chips" group (the
  ranks of one host) and a "hosts" group (the ranks with one chip index);
* ``shard_rows`` (device_put with a row sharding) -> this rank's
  contiguous block of the rows on its device;
* ``shard_merge_rows``/``sharded_encode_step[_2d]`` (jitted
  ``shard_map`` over ``merge_rows_local``) -> functions over this rank's
  block that run ``ops/merge.merge_rows``: the CUDA kernel on a card
  tensor, the plain loop on a CPU tensor. Tables are replicated (each
  rank passes its own copy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..ops.merge import merge_rows

# Every process-group operation fails after this long instead of hanging
# when a rank takes another branch.
TIMEOUT = timedelta(seconds=120)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: its index ``rank`` among ``size``
    ranks, its ``device``, the process ``group`` over all of them and, for
    ``get_mesh_2d``, the ``chips`` and ``hosts`` groups this rank belongs
    to."""

    group: object
    rank: int
    size: int
    device: torch.device
    chips: object = None
    hosts: object = None


def _resolve_device(device) -> torch.device:
    """The caller's device, or cuda:<LOCAL_RANK>; raises without a card
    (or without enough of them) rather than run on the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("get_mesh needs a card, or device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} but only "
                           f"{torch.cuda.device_count()} cards")
    return torch.device("cuda", local)


def _init_default_group(backend: str) -> None:
    """Initialize the default group if none is: from the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) where it is
    set, else as one rank, so that one process is a one-device mesh."""
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)


def _mesh_group(n: int, backend: str):
    """The group of ranks 0..n-1 of the default group: the default group
    itself when it is all of them on ``backend``, else a new group (every
    rank of the default group must call this)."""
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n == world and dist.get_backend() == backend:
        return dist.group.WORLD
    return dist.new_group(list(range(n)), backend=backend, timeout=TIMEOUT)


def _setup(device, backend):
    dev = _resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_default_group(backend)
    return dev, backend


def get_mesh(n_devices: int | None = None, *, device=None,
             backend: str | None = None) -> Mesh | None:
    """1-D mesh over the first ``n_devices`` ranks (all by default).

    Initializes the default process group if none is. ``device`` defaults
    to cuda:<LOCAL_RANK> (raises without such a card); pass "cpu" for the
    plain versions, or one card for several ranks. ``backend`` defaults
    to NCCL for a card and gloo for the CPU. Every rank of the default
    group must call this; a rank outside the mesh gets None."""
    dev, backend = _setup(device, backend)
    n = n_devices or dist.get_world_size()
    group = _mesh_group(n, backend)
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, rank, n, dev)


def get_mesh_2d(n_hosts: int, chips_per_host: int, *, device=None,
                backend: str | None = None) -> Mesh | None:
    """(hosts, chips) mesh over the first n_hosts * chips_per_host ranks,
    rank h * chips_per_host + c holding chip c of host h. Counters reduce
    over ``chips`` (within a host) first, then ``hosts``, so the
    cross-host leg carries one scalar per host. Every rank of the default
    group must call this; a rank outside the mesh gets None."""
    dev, backend = _setup(device, backend)
    need = n_hosts * chips_per_host
    group = _mesh_group(need, backend)
    rank = dist.get_rank()
    chips = hosts = None
    # every rank creates every subgroup, in the same order
    for h in range(n_hosts):
        g = dist.new_group([h * chips_per_host + c
                            for c in range(chips_per_host)],
                           backend=backend, timeout=TIMEOUT)
        if rank // chips_per_host == h:
            chips = g
    for c in range(chips_per_host):
        g = dist.new_group([h * chips_per_host + c for h in range(n_hosts)],
                           backend=backend, timeout=TIMEOUT)
        if rank % chips_per_host == c:
            hosts = g
    if rank >= need:
        return None
    return Mesh(group, rank, need, dev, chips=chips, hosts=hosts)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` (any shape) over the ranks of ``group``: psum."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def shard_rows(mesh: Mesh, byte_buf, lengths):
    """This rank's contiguous block of R packed rows or windows (R
    divisible by the mesh size) on its device: (byte_buf (R/size, C)
    uint8, lengths (R/size,) int32), from numpy arrays or tensors. The
    counterpart of placing an array with the JAX package's row
    sharding."""
    R = len(lengths)
    if R % mesh.size:
        raise ValueError(f"{R} rows do not split over {mesh.size} ranks")
    lo = mesh.rank * (R // mesh.size)
    hi = lo + R // mesh.size

    def part(x, dtype):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        return t[lo:hi].to(mesh.device, dtype).contiguous()

    return part(byte_buf, torch.uint8), part(lengths, torch.int32)


def shard_merge_rows(mesh: Mesh):
    """``fn(byte_buf, lengths, byte_rank, pair_rows, mask) -> (tok,
    counts)`` over this rank's block of rows (``shard_rows``), tables
    replicated on its device: ``merge_rows`` of the block, with no
    communication."""

    def fn(byte_buf, lengths, byte_rank, pair_rows, mask: int):
        return merge_rows(byte_buf, lengths, byte_rank, pair_rows, mask)

    return fn


def _merge_and_count(byte_buf, lengths, byte_rank, pair_rows, mask):
    tok, counts = merge_rows(byte_buf, lengths, byte_rank, pair_rows, mask)
    # int32: a step's shard totals stay far under 2**31
    local = torch.stack([lengths.sum(dtype=torch.int32),
                         counts.sum(dtype=torch.int32)])
    return tok, counts, local


def sharded_encode_step(mesh: Mesh):
    """One data-parallel tokenization step: ``step(byte_buf, lengths,
    byte_rank, pair_rows, mask) -> (tok, counts, bytes_processed,
    tokens_produced)``; tok and counts for this rank's block, the two
    int32 counters summed over the mesh (the same on every rank)."""

    def step(byte_buf, lengths, byte_rank, pair_rows, mask: int):
        tok, counts, local = _merge_and_count(byte_buf, lengths, byte_rank,
                                              pair_rows, mask)
        total = all_sum(local, mesh.group)
        return tok, counts, total[0], total[1]

    return step


def sharded_encode_step_2d(mesh: Mesh):
    """``sharded_encode_step`` over a (hosts, chips) mesh: the counters
    reduce over chips first, then hosts."""
    if mesh.chips is None:
        raise ValueError("sharded_encode_step_2d needs a get_mesh_2d mesh")

    def step(byte_buf, lengths, byte_rank, pair_rows, mask: int):
        tok, counts, local = _merge_and_count(byte_buf, lengths, byte_rank,
                                              pair_rows, mask)
        total = all_sum(all_sum(local, mesh.chips), mesh.hosts)
        return tok, counts, total[0], total[1]

    return step

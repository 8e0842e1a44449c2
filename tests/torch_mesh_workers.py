"""Spawned ranks for the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_resident_mesh*.py): each rank is a fresh process that
imports torch and the port only (never jax), joins a gloo group through
a FileStore and runs one job over the CPU; its result comes back
pickled through a file.

``spawn(world, tmp_path, job, **kwargs)`` starts ``world`` ranks with
start method "spawn", waits at most ``timeout`` seconds for them (a hung
rank fails the test rather than the whole run) and returns each rank's
result in rank order, or raises with the failing rank's traceback."""

from __future__ import annotations

import multiprocessing as mp
import pickle
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np


def spawn(world: int, tmp_path: Path, job: str, timeout: float = 300,
          **kwargs) -> list:
    ctx = mp.get_context("spawn")
    store = tmp_path / f"store_{job}"
    procs = [ctx.Process(target=_entry,
                         args=(rank, world, str(store), job, kwargs,
                               str(tmp_path)))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {job} ran past {timeout} s")
    out = []
    for rank, p in enumerate(procs):
        err = tmp_path / f"{job}_{rank}.err"
        if err.exists():
            raise RuntimeError(f"rank {rank} of {job} failed:\n"
                               + err.read_text())
        if p.exitcode != 0:
            raise RuntimeError(f"rank {rank} of {job} exited {p.exitcode}")
        with open(tmp_path / f"{job}_{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, store, job, kwargs, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the cores: no oversubscription
    out = Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=120))
        result = JOBS[job](**kwargs)
        with open(out / f"{job}_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"{job}_{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(x):
    import torch

    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def steps_job(ranks, buf, lens, D: int):
    """This rank's tok/counts and the counters of ``shard_merge_rows`` and
    ``sharded_encode_step`` over get_mesh(D) (no entries on a rank
    outside it), and of ``sharded_encode_step_2d`` over get_mesh_2d(2, 2)
    when D == 4."""
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.parallel import mesh as PM

    mt = merge_tables_from_ranks(ranks, device="cpu")
    out = {}
    mesh = PM.get_mesh(D, device="cpu")
    if D == 4:
        m2 = PM.get_mesh_2d(2, 2, device="cpu")
        bb, ln = PM.shard_rows(m2, buf, lens)
        out["2d"] = [_np(x) for x in PM.sharded_encode_step_2d(m2)(
            bb, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask)]
    if mesh is None:
        return out
    bb, ln = PM.shard_rows(mesh, buf, lens)
    args = (bb, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask)
    out["merge"] = [_np(x) for x in PM.shard_merge_rows(mesh)(*args)]
    out["step"] = [_np(x) for x in PM.sharded_encode_step(mesh)(*args)]
    return out


def sharded_text_job(cases, D: int):
    """``ShardedTextEncoder`` over get_mesh(D) at 2048-byte shards and a
    512-byte halo: for each (pattern, ranks, texts) one encoder, and per
    text (ids, passes, fallbacks) counted for that text alone."""
    from tokendagger_tpu_torch import DeviceEngine
    from tokendagger_tpu_torch.parallel.mesh import get_mesh
    from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder

    mesh = get_mesh(D, device="cpu")
    out = []
    for pattern, ranks, texts in cases:
        eng = DeviceEngine(pattern, ranks, {}, device="cpu")
        st = ShardedTextEncoder(eng, mesh, shard_bytes=2048, halo=512)
        res = []
        for text in texts:
            p0, f0 = st.passes, st.fallbacks
            ids = st.encode(text)
            res.append((ids, st.passes - p0, st.fallbacks - f0))
        out.append(res)
    return out


def parallel_job(ranks, buf, lens, cases):
    """Everything tests/test_torch_parallel.py runs at world size 4."""
    return {"steps4": steps_job(ranks, buf, lens, 4),
            "steps2": steps_job(ranks, buf, lens, 2),
            "text4": sharded_text_job(cases, 4)}


def resident_mesh_job(ranks, window: int, p_cap: int, configs,
                      device="cpu", backend=None):
    """``mesh_resident_pipeline`` over get_mesh(2) for each (kwargs,
    windows, nbytes) of ``configs``: this rank's 11 outputs as numpy."""
    import torch

    from tokendagger_tpu_torch.convert import tables_from_ranks
    from tokendagger_tpu_torch.parallel.mesh import get_mesh, shard_rows
    from tokendagger_tpu_torch.parallel.resident_mesh import (
        mesh_resident_pipeline,
    )
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    mesh = get_mesh(2, device=device, backend=backend)
    tables = tables_from_ranks(ranks, device=device)
    page_ids, pages = (torch.from_numpy(a.astype(np.int64))
                       for a in get_two_level_tables())
    out = []
    for kw, wins, nbs in configs:
        fn = mesh_resident_pipeline(mesh, tables, page_ids, pages,
                                    window=window, p_cap=p_cap, **kw)
        out.append([_np(x) for x in fn(*shard_rows(mesh, wins, nbs))])
    return out


def card_pair_job(ranks, text, window, p_cap, configs):
    """Two ranks on two cards over NCCL (the default group is gloo; the
    mesh is a new NCCL group): the sharded text's ids and the mesh
    pipeline's outputs."""
    import torch.distributed as dist

    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine
    from tokendagger_tpu_torch.parallel.mesh import get_mesh
    from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder

    dev = f"cuda:{dist.get_rank()}"
    mesh = get_mesh(2, device=dev, backend="nccl")
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, {}, device=dev)
    st = ShardedTextEncoder(eng, mesh, shard_bytes=2048, halo=512)
    ids = st.encode(text)
    return {"ids": ids, "passes": st.passes, "fallbacks": st.fallbacks,
            "mesh": resident_mesh_job(ranks, window, p_cap, configs,
                                      device=dev, backend="nccl")}


JOBS = {"parallel": parallel_job, "resident_mesh": resident_mesh_job,
        "card_pair": card_pair_job}

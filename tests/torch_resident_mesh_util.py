"""Shared body of tests/test_torch_resident_mesh.py and
test_torch_resident_mesh_collide.py: the port's mesh_resident_pipeline
at D = 2 (two spawned gloo ranks) and D = 1 (this process) against the
JAX package's at get_mesh(2) with interpret=True, and against the host
engine, on one vocabulary per file (the JAX package compiles each
configuration for ~50 s in interpret mode, so two files spread them
over the test workers). The JAX package is imported only by
``jax_outputs`` and ``windows(check_jax=True)``: the card tests
(tests/test_torch_cuda.py, on a machine without JAX) use the rest."""

from collections import Counter

import numpy as np

import torch_mesh_workers
from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine, byte_pair_merge
from tokendagger_tpu_torch.convert import tables_from_ranks
from tokendagger_tpu_torch.ops.fused import SENTINEL, caps_for
from tokendagger_tpu_torch.ops.join import piece_key_words
from tokendagger_tpu_torch.parallel.mesh import get_mesh, shard_rows
from tokendagger_tpu_torch.parallel.resident_mesh import (
    mesh_resident_pipeline,
)
from tokendagger_tpu_torch.unicode_tables import get_two_level_tables
from tokendagger_tpu_torch.utils.windows import tile_windows
from torch_port_util import multiscript_text, prose_text

WINDOW = 1 << 15   # the JAX test's window: one butterfly block
B = 4              # windows: two per rank
P_CAP = caps_for(WINDOW)["p_cap"]
CONFIGS = ("ascii", "ascii+hot", "general", "general+hot")


def windows(seed: int, check_jax: bool = False):
    """(ascii windows, multi-script windows), each (wins, nbs) tiled by
    the port's tile_windows; with ``check_jax`` the JAX package's must
    give the same."""
    rng = np.random.default_rng(seed)
    out = []
    for text in (prose_text(rng, 5 * WINDOW), multiscript_text(rng, 5 * WINDOW)):
        corpus = text.encode()
        wins, nbs = tile_windows(corpus, WINDOW, B)
        if check_jax:
            from tokendagger_tpu.utils.windows import tile_windows as jax_tw

            jw, jn = jax_tw(corpus, WINDOW, B)
            assert np.array_equal(wins, jw) and np.array_equal(nbs, jn)
        out.append((wins, nbs))
    return out


def _hot_probe(ranks, wins, nbs):
    """The 64 most common pieces of at most 16 bytes (the JAX test's
    host staging)."""
    host = HostEngine(LLAMA4_PATTERN, ranks, {})
    pc: Counter = Counter()
    per = []
    for b in range(len(nbs)):
        txt = bytes(wins[b, : nbs[b]]).decode("utf-8")
        pieces = [txt[a:e].encode() for a, e in host.split_spans(txt)]
        per.append(pieces)
        pc.update(p for p in pieces if len(p) <= 16)
    hot = [p for p, _ in pc.most_common(64)]
    hs = frozenset(hot)
    max_unknown = max(sum(1 for p in ps if p not in hs) for ps in per)
    return dict(hot_keys=tuple(piece_key_words(p) for p in hot),
                hot_ranks=tuple(ranks.get(p, -1) for p in hot),
                u_cap=max(4096, -(-(max_unknown + 128) // 128) * 128))


def _hot_classes(wins, nbs):
    hist: Counter = Counter()
    for b in range(len(nbs)):
        cps = np.frombuffer(bytes(wins[b, : nbs[b]]).decode("utf-8")
                            .encode("utf-32-le"), np.uint32).astype(np.int32)
        vals, cnts = np.unique(cps, return_counts=True)
        hist.update(dict(zip(vals.tolist(), cnts.tolist())))
    return dict(hot_cps=tuple(v for v, _ in hist.most_common(32)),
                u_cap=WINDOW)


def configs(ranks, seed: int, check_jax: bool = False) -> dict:
    """name -> (kwargs, wins, nbs) for the four configurations."""
    (aw, an), (gw, gn) = windows(seed, check_jax)
    return {
        "ascii": (dict(impl="ascii"), aw, an),
        "ascii+hot": (dict(impl="ascii", probe_hot_cfg=_hot_probe(
            ranks, aw, an)), aw, an),
        "general": (dict(impl="general", c_cap=WINDOW), gw, gn),
        "general+hot": (dict(impl="general", c_cap=WINDOW,
                             class_hot_cfg=_hot_classes(gw, gn),
                             probe_hot_cfg=_hot_probe(ranks, gw, gn)),
                        gw, gn),
    }


def spawn_d2(ranks, cfgs, tmp_path) -> dict:
    """name -> the 11 outputs of the two ranks at D = 2, per-window
    outputs concatenated in rank order; both ranks' counters must agree."""
    per_rank = torch_mesh_workers.spawn(
        2, tmp_path, "resident_mesh", ranks=ranks, window=WINDOW,
        p_cap=P_CAP, configs=[cfgs[n] for n in CONFIGS])
    out = {}
    for i, name in enumerate(CONFIGS):
        r0, r1 = per_rank[0][i], per_rank[1][i]
        assert all(int(a) == int(b) for a, b in zip(r0[9:], r1[9:]))
        out[name] = [np.concatenate([a, b]) for a, b in zip(r0[:9], r1[:9])] \
            + [np.asarray(x) for x in r0[9:]]
    return out


def port_d1(ranks, cfg):
    """The same pipeline over a one-rank mesh in this process."""
    import torch

    kw, wins, nbs = cfg
    mesh = get_mesh(1, device="cpu")
    page_ids, pages = (torch.from_numpy(a.astype(np.int64))
                       for a in get_two_level_tables())
    fn = mesh_resident_pipeline(mesh, tables_from_ranks(ranks, device="cpu"),
                                page_ids, pages, window=WINDOW, p_cap=P_CAP,
                                **kw)
    return [x.numpy() for x in fn(*shard_rows(mesh, wins, nbs))]


def jax_outputs(ranks, cfg):
    import jax
    import jax.numpy as jnp

    from tokendagger_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from tokendagger_tpu.parallel.resident_mesh import (
        mesh_resident_pipeline as jax_pipeline,
    )
    from tokendagger_tpu.tables import build_tables
    from tokendagger_tpu.unicode_tables import (
        get_two_level_tables as jax_pages,
    )

    kw, wins, nbs = cfg
    tables = build_tables(ranks, {}, use_cache=False)
    page_ids, pages = map(jnp.asarray, jax_pages())
    fn, sh = jax_pipeline(jax_get_mesh(2), tables, page_ids, pages,
                          window=WINDOW, p_cap=P_CAP, interpret=True, **kw)
    out = fn(jax.device_put(jnp.asarray(wins), sh[0]),
             jax.device_put(jnp.asarray(nbs), sh[1]))
    return [np.asarray(x) for x in out]


def assert_equal(got, want):
    assert len(got) == len(want) == 11
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), k


def assert_host(ranks, cfg, out):
    """Each window's ids, misses spliced, equal the host engine's; no
    overflow; the counters are the totals."""
    _, wins, nbs = cfg
    flat, n_kept, overflow, ms_s, ms_l, n_ms = (out[0], out[1], out[5],
                                                out[6], out[7], out[8])
    assert not overflow.any()
    assert int(out[9]) == int(n_kept.sum()) and int(out[10]) == int(nbs.sum())
    host = HostEngine(LLAMA4_PATTERN, ranks, {})
    for b in range(len(nbs)):
        ids = flat[b][: int(n_kept[b])].tolist()
        window_b = bytes(wins[b, : nbs[b]])
        got, prev = [], 0
        for j, p in enumerate(np.nonzero(np.asarray(ids) == SENTINEL)[0]):
            got += ids[prev:p]
            piece = window_b[int(ms_s[b][j]) : int(ms_s[b][j] + ms_l[b][j])]
            got += ([ranks[piece]] if piece in ranks
                    else byte_pair_merge(piece, ranks))
            prev = p + 1
        got += ids[prev:]
        assert int(n_ms[b]) == len(np.nonzero(np.asarray(ids) == SENTINEL)[0])
        assert got == host.encode_ordinary(window_b.decode("utf-8")), b

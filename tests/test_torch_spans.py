"""The port's ``td.*`` spans (``utils/profiling.span``) and the
``spliced_whole`` counter, on the CPU: the ranges a traced encode leaves,
their nesting on one thread, that no range is entered while no profiler
records, and the ``td.gc`` range of a collection."""

import gc

import numpy as np
import pytest
import torch

from conftest import make_tiny_vocab
from torch_port_util import multiscript_text, prose_text
from tokendagger_tpu_torch import (
    LLAMA4_PATTERN, DeviceEngine, HostEngine, Tokenizer,
)
from tokendagger_tpu_torch.utils import profiling

WINDOW_STAGES = ["td.window.stage", "td.window.decode", "td.window.starts",
                 "td.window.compact", "td.window.probe",
                 "td.window.finalize", "td.window.read"]
SLACK_US = 1.0       # the trace's timestamps are rounded


def _traced(tmp_path, fn):
    """(fn's result, the td.* ranges of its trace as (name, tid, start,
    end), in order of start; ``td.gc`` left out: a collection may fall
    anywhere while the profiler records)."""
    with profiling.profile_trace(str(tmp_path)):
        out = fn()
    events = profiling.trace_events(str(tmp_path))
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("td.")
                   and e["name"] != "td.gc")
    return out, [(n, tid, a, b) for a, b, n, tid in spans]


def _inside(child, parent):
    return (child[1] == parent[1] and child[2] >= parent[2] - SLACK_US
            and child[3] <= parent[3] + SLACK_US)


def _text_with_special_and_misses(seed: int, specials) -> str:
    """Over 64 KB (two CPU windows and more) of prose, a special, then
    multi-script text: the tiny vocabulary misses many pieces."""
    rng = np.random.default_rng(seed)
    return (prose_text(rng, 90000) + next(iter(specials))
            + multiscript_text(rng, 8000))


def test_a_traced_encode_nests_its_spans_on_one_thread(tmp_path):
    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="device", device="cpu")
    text = _text_with_special_and_misses(3, specials)
    want = HostEngine(LLAMA4_PATTERN, ranks, specials).encode(
        text, set(specials))[0]
    eng = tok._get_device()
    w0 = eng.stats.windows
    ids, spans = _traced(
        tmp_path, lambda: tok.encode(text, allowed_special="all"))
    assert ids == want
    assert eng.stats.spliced_pieces > 0
    calls = [s for s in spans if s[0] == "td.encode"]
    assert len(calls) == 1
    call = calls[0]
    inner = [s for s in spans if s is not call]
    assert inner and all(_inside(s, call) for s in inner)
    names = [s[0] for s in inner]
    for name in ("td.specials", "td.splice", "td.lists", "td.utf8",
                 "td.drain", "td.copyback"):
        assert name in names, name
    windows = [s for s in inner if s[0] == "td.window"]
    assert len(windows) >= 2
    assert len(windows) == eng.stats.windows - w0
    for w in windows:
        kids = [s[0] for s in inner
                if s[0].startswith("td.window.") and _inside(s, w)]
        assert kids == WINDOW_STAGES
    # every splice lies inside a drain, and every drain after its window
    drains = [s for s in inner if s[0] == "td.drain"]
    for s in inner:
        if s[0] in ("td.splice", "td.copyback"):
            assert any(_inside(s, d) for d in drains), s
    for d in drains:
        assert not any(_inside(d, w) for w in windows)


def test_a_lone_segment_and_a_batch_each_run_one_window_section(tmp_path):
    """One complete segment alone and the same segment among three run
    through the one window executor: one ``td.window`` each call (a batch
    of one, then of three), equal ids, and the host engine's."""
    ranks, specials = make_tiny_vocab()
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    rng = np.random.default_rng(6)
    segs = [multiscript_text(rng, 20000).encode(),
            prose_text(rng, 30000).encode(),
            multiscript_text(rng, 6000).encode()]
    want = [host.encode_ordinary(s.decode()) for s in segs]
    for call, (sub, n) in enumerate([(segs[:1], 1), (segs, 3)]):
        w0, b0 = eng.stats.windows, eng.stats.window_batches
        got, spans = _traced(tmp_path / str(call),
                             lambda: eng.encode_streams(sub))
        assert [g.tolist() for g in got] == want[:n]
        names = [s[0] for s in spans]
        assert names.count("td.window") == 1
        assert names.count("td.drain") == names.count("td.copyback") == 1
        assert (eng.stats.windows - w0, eng.stats.window_batches - b0) == (
            n, 1)
    assert eng.stats.spliced_pieces > 0


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    ranks, specials = make_tiny_vocab()
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="device", device="cpu")
    rng = np.random.default_rng(5)
    text = _text_with_special_and_misses(5, specials)
    short = [multiscript_text(rng, int(k)) for k in (40, 300, 900, 2000)]
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tok.encode(text, allowed_special="all") == host.encode(
        text, set(specials))[0]
    # the grids (four short texts), the ordinary route, the batch np route
    assert tok.encode_batch(short) == [host.encode_ordinary(s)
                                       for s in short]
    assert tok.encode_ordinary(short[1]) == host.encode_ordinary(short[1])
    assert [a.tolist() for a in tok.encode_batch_np(short)] == [
        host.encode_ordinary(s) for s in short]
    with pytest.raises(ValueError):
        tok.encode(next(iter(specials)))
    gc.collect()
    assert tok._get_device().stats.grids >= 1


def test_gc_under_the_profiler_leaves_a_gc_range(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        gc.collect()
    names = [e.get("name") for e in profiling.trace_events(str(tmp_path))
             if e.get("cat") == "user_annotation"]
    assert "td.gc" in names


def test_a_span_closes_its_range_when_the_block_raises(tmp_path):
    def fail():
        with profiling.span("td.outer"):
            try:
                with profiling.span("td.inner"):
                    raise KeyError("x")
            except KeyError:
                pass
        # closing a span never opened does nothing (the engine's drain)
        profiling.span("td.never").__exit__(None, None, None)
        return 1

    _, spans = _traced(tmp_path, fail)
    outer, inner = spans
    assert (outer[0], inner[0]) == ("td.outer", "td.inner")
    assert _inside(inner, outer)


def test_spliced_whole_counts_whole_tokens_the_probe_cannot_key():
    ranks, specials = make_tiny_vocab()
    long_tok = b" supercalifragilistic"            # one piece, 21 bytes
    ranks[long_tok] = len(ranks)
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    text = ("the cat" + long_tok.decode() + " zqxv the" + long_tok.decode()
            + " and")
    assert eng.encode_stream(text.encode()).tolist() == host.encode_ordinary(
        text)
    st = eng.stats
    assert st.spliced_whole == 2              # the long token, twice
    assert st.spliced_pieces > st.spliced_whole   # " zqxv" is absent
    # the grid route counts its splices too
    segs = [text.encode(), long_tok, b" zqxv", b"the"]
    got = eng.encode_streams(segs)
    assert [g.tolist() for g in got] == [host.encode_ordinary(s.decode())
                                         for s in segs]
    assert st.grids >= 1
    assert st.spliced_whole == 2 + 3
    assert st.spliced_whole <= st.spliced_pieces

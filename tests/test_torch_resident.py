"""The slice as a whole: the port's ``run_resident`` (the batched general
pipeline and the fused ASCII one; the other combinations in
test_torch_single.py and test_torch_combos.py) on the CPU, against the
host engine and against one call of the JAX package's ``run_resident``
(Pallas kernels in interpret mode); and the port's profiling helpers."""

import json

import numpy as np
import pytest
import torch

from tests.conftest import make_tiny_vocab
from tokendagger_tpu.resident import run_resident as jax_run_resident
from tokendagger_tpu.utils import profiling as JPF
from tokendagger_tpu_torch import LLAMA4_PATTERN, ResidentResult, run_resident
from tokendagger_tpu_torch.ops import compact as TC
from tokendagger_tpu_torch.utils import profiling as TPF
from torch_port_util import multiscript_text, prose_text

W = 1 << 15
COMPARED = ("impl", "match_host", "total_tokens", "cap_bpp", "probe_impl",
            "probe_hot", "overflow_windows")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return multiscript_text(rng, 3 * W).encode()


def _port(corpus, cap, **kw):
    ranks, specials = make_tiny_vocab()
    return run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                        n_windows=2, batch=2, reps=1, overlap_trial=False,
                        cap_bytes_per_piece=cap, probe_impl="chunks",
                        device="cpu", **kw)


class _Calls:
    """Counts calls of the route kernels' plain versions (the CPU runs
    them where the card launches K5+K6 and K7+K8)."""

    def __init__(self, monkeypatch):
        self.n = {"compact": 0, "expand": 0}
        for name, key in (("compact_record_plain", "compact"),
                          ("expand_route_plain", "expand")):
            fn = getattr(TC, name)

            def spy(*a, _fn=fn, _key=key, **k):
                self.n[_key] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(TC, name, spy)


@pytest.mark.parametrize("cap", [3.0, 0])
def test_general_pipeline_matches_host(corpus, cap, monkeypatch):
    calls = _Calls(monkeypatch)
    r = _port(corpus, cap)
    assert isinstance(r, ResidentResult)
    assert r.impl == "general" and r.match_host
    assert r.overflow_windows == 0 and r.total_tokens > 0
    assert r.starts_impl == "bits-pallas" and r.compact_impl == "butterfly"
    # no device: no device times (as the JAX package reports off the TPU)
    assert r.device_ms == 0.0 and r.stage_us == {} and r.kernel_mbps == 0.0
    # three pipeline runs (warm-up, one timed repetition, the check): the
    # decode's route once each, plus the hot codepoints' and the hot
    # pieces' under the auto capacity
    per_batch = 3 if cap == 0 else 1
    assert calls.n == {"compact": 3 * per_batch, "expand": 3 * per_batch}
    if cap == 0:
        assert r.probe_impl == "hot"
        assert r.probe_hot["n_hot"] > 0 and r.probe_hot["u_cap"] % 128 == 0
    else:
        assert r.probe_impl == "chunks" and r.cap_bpp == 3.0


def test_equals_jax_run_resident(corpus):
    """One JAX ``run_resident`` call (auto capacity: both hot routes)."""
    ranks, specials = make_tiny_vocab()
    want = jax_run_resident(ranks, specials, LLAMA4_PATTERN, corpus,
                            window=W, n_windows=2, batch=2, reps=1,
                            overlap_trial=False, cap_bytes_per_piece=0,
                            probe_impl="chunks")
    got = _port(corpus, 0)
    assert want.match_host and want.probe_impl == "hot"
    for f in COMPARED:
        assert getattr(got, f) == getattr(want, f), f
    assert got.starts_impl == want.starts_impl
    assert got.compact_impl == want.compact_impl


def test_fused_ascii_pipeline_matches_host():
    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(1)
    ascii_corpus = prose_text(rng, 3 * W).encode()
    for cap in (3.0, 0):
        r = run_resident(ranks, specials, LLAMA4_PATTERN, ascii_corpus,
                         window=W, n_windows=2, batch=2, reps=1,
                         overlap_trial=True, cap_bytes_per_piece=cap,
                         starts_impl="bits-pallas", compact_impl="butterfly",
                         probe_impl="chunks", device="cpu")
        assert r.impl == "ascii-sort" and r.match_host
        assert r.overflow_windows == 0
        assert r.overlap["n_batches"] == 4


@pytest.mark.parametrize("kw,text", [
    (dict(batch=1), "multiscript"),
    (dict(batch=2, impl="sort"), "multiscript"),
    (dict(batch=2, impl="ascii-sort"), "ascii"),
])
def test_left_out_combinations_raise(corpus, kw, text):
    """The combinations that raised until the single-window pipeline and
    the other batched stages were ported now run, here with the auto
    capacity and the chunks probe (the hot-piece route when batched),
    and equal the host engine."""
    ranks, specials = make_tiny_vocab()
    if text == "ascii":
        corpus = prose_text(np.random.default_rng(4), 3 * W).encode()
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                     n_windows=2, reps=1, cap_bytes_per_piece=0,
                     probe_impl="chunks", overlap_trial=False, device="cpu",
                     **kw)
    assert r.match_host and r.overflow_windows == 0
    assert r.probe_impl == ("hot" if kw["batch"] > 1 else "chunks")


def test_device_miss_mode_and_sort_join_as_the_reference(corpus):
    """The reference's batched mode refuses miss_mode="device" with a
    ValueError, and its batched pipelines do not read join_mode."""
    ranks, specials = make_tiny_vocab()
    with pytest.raises(ValueError, match="requires miss_mode='host'"):
        run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                     n_windows=2, batch=2, miss_mode="device", device="cpu")
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                     n_windows=2, batch=2, reps=1, join_mode="sort",
                     overlap_trial=False, device="cpu")
    assert r.match_host and r.impl == "general"


def test_more_than_one_trial_raises(corpus):
    ranks, specials = make_tiny_vocab()
    with pytest.raises(ValueError, match="one trial"):
        run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                     n_windows=2, batch=2, trials=2, device="cpu")


def test_default_device_is_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ranks, specials = make_tiny_vocab()
    with pytest.raises(RuntimeError):
        run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=W,
                     n_windows=2, batch=2)


def test_profiling_helpers(tmp_path):
    with TPF.profile_trace(str(tmp_path)) as prof:
        torch.arange(1000).sum()
    assert list(tmp_path.glob("*.json"))
    assert prof.key_averages() is not None
    for mod in (TPF, JPF):
        m = mod.RateMeter("llama")
        m.add(2_000_000, 500_000, 0.5)
        assert m.mb_per_s == 4.0 and m.tokens_per_s == 1_000_000
    a, b = TPF.RateMeter("x"), JPF.RateMeter("x")
    for m in (a, b):
        m.add(123456, 789, 0.25)
    assert json.loads(a.to_json()) == json.loads(b.to_json())


def test_device_busy_us(tmp_path):
    # a CPU trace holds no device activity
    with TPF.profile_trace(str(tmp_path / "cpu")):
        torch.arange(1000).sum()
    assert TPF.device_busy_us(str(tmp_path / "cpu")) == (0.0, 0)
    assert TPF.device_busy_us(str(tmp_path / "none")) == (0.0, 0)
    # overlapping and nested intervals count once; host events not at all
    ev = [dict(ph="X", cat="kernel", ts=10.0, dur=5.0),
          dict(ph="X", cat="kernel", ts=12.0, dur=1.0),
          dict(ph="X", cat="gpu_memcpy", ts=14.0, dur=4.0),
          dict(ph="X", cat="gpu_memset", ts=30.0, dur=2.0),
          dict(ph="X", cat="cpu_op", ts=0.0, dur=100.0),
          dict(ph="i", cat="kernel", ts=50.0)]
    (tmp_path / "h.1.pt.trace.json").write_text(json.dumps(
        {"traceEvents": ev}))
    assert TPF.device_busy_us(str(tmp_path)) == (10.0, 2)


def _trace(tmp_path, events):
    (tmp_path / "h.1.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    return TPF.trace_events(str(tmp_path))


def test_stage_device_us_attributes_through_correlation(tmp_path):
    """A kernel counts for the range whose thread launched it (runtime
    call inside the range, joined by correlation), wherever the kernel
    itself lies in time; copies and memsets count too, the gaps between
    kernels and the gpu_user_annotation spans do not."""
    def rng_(name, ts, dur, tid=1):
        return dict(ph="X", cat="user_annotation", name=name, pid=7,
                    tid=tid, ts=ts, dur=dur)

    def rt(corr, ts, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
        return dict(ph="X", cat=cat, name=name, pid=7, tid=tid, ts=ts,
                    dur=1.0, args={"correlation": corr})

    def dev(corr, ts, dur, cat="kernel", name="void k<1>(int)"):
        return dict(ph="X", cat=cat, name=name, pid=0, tid=7, ts=ts,
                    dur=dur, args={"correlation": corr})

    events = _trace(tmp_path, [
        rng_("decode", 0.0, 10.0), rng_("starts", 10.0, 10.0),
        rng_("probe", 30.0, 5.0), rng_("other", 40.0, 5.0),
        rng_("compact", 0.0, 100.0, tid=2),
        rt(1, 2.0), rt(2, 5.0, name="cudaMemcpyAsync"),
        rt(3, 12.0, cat="cuda_driver", name="cuLaunchKernel"),
        rt(4, 25.0),                   # between ranges: no stage
        rt(5, 41.0),                   # a range not asked for
        rt(6, 50.0, tid=2),            # another thread's range
        rt(7, 19.0, name="cudaLaunchCooperativeKernel"),
        dev(1, 100.0, 3.0), dev(2, 104.0, 2.5, cat="gpu_memcpy"),
        dev(3, 200.0, 4.0), dev(7, 300.0, 1.5, name="void other_k()"),
        dev(4, 400.0, 9.0), dev(5, 500.0, 9.0), dev(6, 600.0, 6.0),
        dev(8, 700.0, 9.0),            # no runtime event
        dict(ph="X", cat="gpu_user_annotation", name="decode", pid=0,
             tid=7, ts=100.0, dur=200.0),
        dict(ph="X", cat="gpu_memset", name="Memset", pid=0, tid=7,
             ts=5.0, dur=0.5, args={"correlation": 9}), rt(9, 31.0),
    ])
    got = TPF.stage_device_us(events, ("decode", "starts", "probe",
                                       "compact", "finalize"))
    assert got == {"decode": 5.5, "starts": 5.5, "probe": 0.5,
                   "compact": 6.0}
    assert TPF.kernel_counts(events, ["k", "other_k", "k<2>", "none"]) == {
        "k": 6, "other_k": 1, "k<2>": 0, "none": 0}
    # launched inside the named ranges only: corr 1, 3 and 7
    assert TPF.kernel_counts(events, ["k", "other_k"], ("decode", "starts")
                             ) == {"k": 2, "other_k": 1}
    assert TPF.trace_events(str(tmp_path / "missing")) == []


def test_stage_device_us_on_a_cpu_trace(tmp_path):
    """A CPU trace has the ranges but no device events: 0 per range."""
    with TPF.profile_trace(str(tmp_path)):
        with torch.profiler.record_function("decode"):
            torch.arange(1000).sum()
    events = TPF.trace_events(str(tmp_path))
    assert TPF.stage_device_us(events, ("decode", "probe")) == {"decode": 0.0}


def test_cpu_run_reports_no_device_or_event_times(corpus):
    r = _port(corpus, 3.0)
    assert r.match_host and r.stage_us == {} and r.device_ms == 0.0
    assert r.event_us == {} and r.event_ms == 0.0
    assert r.trace_kernels == {} and r.trace_kernel_shortfall == {}

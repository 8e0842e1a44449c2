"""run.py end to end on the CPU: no result without a card; a sound run of
the port (its plain versions) is correct; the controls and faults planted
underneath the timed path come out as not correct."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tdbench import run, standin
from tdbench.byname import load, names
from tdbench.reference.control import CONTROLS, program
from tdbench.reference.encode import Reference

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(cell: str, count: int = 6, high: int = 12000):
    _, _, config, mix = run.load_cell(cell)
    sizes = dict(mix["sizes"], count=count, high=min(high,
                                                     mix["sizes"]["high"]))
    sizes["low"] = min(sizes["low"], sizes["high"] // 2)
    mix = dict(mix, sizes=sizes, trace_units=2, check_share=1.0)
    mix["forms"] = [dict(f, every=2048) if f["name"] == "between" else f
                    for f in mix["forms"]]
    config = dict(config, n_mergeable_ranks=20000, assumed=dict(
        config["assumed"], sample_bytes={"prose": 1 << 16,
                                         "code": 1 << 13}))
    return mix, config


def cpu_run(cell: str, trace: bool = False, **kw):
    mix, config = small(cell)
    return run.run_cell(cell, 2**31 + 99, 0.3, trace, device="cpu",
                        mix=mix, config=config, **kw)[0]


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "tdbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"metrics"' not in p.stdout


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "tdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "tdbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"metrics"' not in p.stdout


def test_reference_equals_tiktoken():
    tiktoken = pytest.importorskip("tiktoken")
    for name in ("o200k", "cl100k"):
        config = json.loads((HERE / "configs" / f"{name}.json").read_text())
        config = dict(config, n_mergeable_ranks=30000, assumed=dict(
            config["assumed"], sample_bytes={"prose": 1 << 16,
                                             "code": 1 << 13}))
        ranks = standin.standin_ranks(config, 5)
        specials = config["special_tokens"]
        enc = tiktoken.Encoding(name, pat_str=config["pat_str"],
                                mergeable_ranks=ranks,
                                special_tokens=specials)
        ref = Reference(config["pat_str"], ranks, specials)
        sp = "".join(specials)
        for pool in names("pools"):
            text = load("pools", pool).make(1 << 16, 9)
            text = text[:5000] + sp + text[5000:] + "x\U0001d400\U00020000"
            assert ref.encode(text) == enc.encode(text,
                                                  allowed_special="all")


@pytest.mark.parametrize("cell", ["o200k.docs", "cl100k.prompts"])
def test_sound_run_is_correct(cell):
    res = cpu_run(cell, trace=True)
    assert res["correct"], res["check"]
    assert res["check"]["checked_calls"]["value"] >= 1
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell,sliced", [("o200k.docs", False),
                                         ("cl100k.code", True)])
def test_untraced_run_takes_a_slice_for_a_device_trace_metric(
        cell, sliced, monkeypatch):
    """An untraced run traces its slice only where one of the cell's
    end-to-end metrics is read from the device trace (``card_mbps``), and
    its line never carries the trace's own keys."""
    calls = []
    monkeypatch.setattr(run, "traced_slice", lambda *a: calls.append(a))
    res = cpu_run(cell)
    assert bool(calls) == sliced
    assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_control_is_not_correct(cell, control):
    mix, config = small(cell)
    mix["check_share"] = 1.0
    res = run.run_cell(cell, 2**31 + 7, 0.3, False, device="cpu", mix=mix,
                       config=config, program=program(control))[0]
    assert not res["correct"]
    assert res["check"]["wrong_calls"]["value"] >= 1


def altered_id(monkeypatch):
    """One id altered where the engine produces it."""
    from tokendagger_tpu_torch import engine

    real = engine.DeviceEngine.encode_streams

    def encode_streams(self, segments):
        out = real(self, segments)
        for ids in out:
            if len(ids):
                ids[len(ids) // 2] += 1
                break
        return out
    monkeypatch.setattr(engine.DeviceEngine, "encode_streams",
                        encode_streams)


def unchanged(monkeypatch):
    """A call that returns what the one before it returned."""
    from tokendagger_tpu_torch import engine

    real = engine.DeviceEngine.encode_batch
    last = {}

    def encode_batch(self, texts, allowed):
        out = last.get("out") or real(self, texts, allowed)
        last["out"] = real(self, texts, allowed)
        return out
    monkeypatch.setattr(engine.DeviceEngine, "encode_batch", encode_batch)


@pytest.mark.parametrize("fault,cell", [
    (altered_id, "o200k.docs"), (altered_id, "cl100k.code"),
    (unchanged, "cl100k.prompts")],
    ids=["altered_id-docs", "altered_id-code", "unchanged-prompts"])
def test_fault_is_not_correct(fault, cell, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(cell)
    assert not res["correct"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "tdbench/run.py", "--workload",
                        "cl100k.prompts", "--seed", str(2**31 + 3),
                        "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_a_fault_in_one_unit_is_caught_without_a_sample(monkeypatch):
    """The first call of each unit is checked, so a fault that hits only
    the largest document is caught even where no call is sampled."""
    from tokendagger_tpu_torch import engine

    mix, config = small("o200k.docs")
    mix["check_share"] = 0.0
    real = engine.DeviceEngine.encode_streams
    longest = max(run.traffic.sizes(mix["sizes"]))

    def encode_streams(self, segments):
        out = real(self, segments)
        if sum(len(s) for s in segments) >= longest - 16:
            out[0][0] += 1
        return out
    monkeypatch.setattr(engine.DeviceEngine, "encode_streams",
                        encode_streams)
    res = run.run_cell("o200k.docs", 2**31 + 99, 3.0, False, device="cpu",
                       mix=mix, config=config)[0]
    assert res["attempted"] >= mix["sizes"]["count"]
    assert not res["correct"]
    assert res["check"]["checked_calls"]["value"] == mix["sizes"]["count"]
    assert res["check"]["wrong_calls"]["value"] == 1

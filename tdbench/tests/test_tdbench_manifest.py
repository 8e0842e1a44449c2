"""BENCHMARK.json against the benchmark's contract, and the imports of the
benchmark's own files."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
LINE = re.compile(r"[^\n\t]{1,200}\Z")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["tdbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["command"][1].startswith("tdbench/")


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in METRICS]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [c["name"] for c in MANIFEST["configs"]]
    names += [w[k] for w in MANIFEST["workloads"]
              for k in ("config", "traffic")]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in MANIFEST[group]]
        assert len(got) == len(set(got)), group
    texts = [w["why"] for w in MANIFEST["workloads"]]
    texts += [c[k] for c in MANIFEST["configs"] for k in ("why", "source")]
    texts += [m["layer"] for m in MANIFEST["per_layer"]]
    for t in texts:
        assert LINE.match(t), t


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"setup_s", "doc_mbps", "card_mbps",
                        "request_p95_ms"}
    assert "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def reports(cell: str) -> set:
    return {m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_per_layer_metric_is_reported_where_its_metric_is():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert m["moves"] in reports(cell), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for w in MANIFEST["workloads"]:
        got = reports(w["name"])
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m["workloads"]
                   for m in MANIFEST["per_layer"]), w["name"]


def test_cells_and_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
        assert w["config"] in configs
    assert len(pairs) == len(MANIFEST["workloads"])
    for c in configs.values():
        assert c["file"].startswith("tdbench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == []
        assert 1 <= len(data["source"]) <= 200
        assert data["assumed"]["mergeable_ranks"]
        assert data["assumed"]["sample_bytes"]
        assert c["source"].startswith("https://")
    for m in METRICS:
        assert (HERE / "metrics" / f"{m['name'].split('.')[0]}.py").exists()


def test_published_shapes():
    o = json.loads((HERE / "configs" / "o200k.json").read_text())
    c = json.loads((HERE / "configs" / "cl100k.json").read_text())
    assert o["n_mergeable_ranks"] == 199998
    assert o["special_tokens"] == {"<|endoftext|>": 199999,
                                   "<|endofprompt|>": 200018}
    assert c["n_mergeable_ranks"] == 100256
    assert c["special_tokens"] == {
        "<|endoftext|>": 100257, "<|fim_prefix|>": 100258,
        "<|fim_middle|>": 100259, "<|fim_suffix|>": 100260,
        "<|endofprompt|>": 100276}


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imports(path) & {"jax", "jaxlib", "flax", "tokendagger_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert "tokendagger_tpu_torch" not in imports(path)
    assert "tokendagger" not in path.read_text()

"""Kimi K2's configuration (``configs/kimi_k2.json``), its pool ``zh``, the
traffic ``docs_zh`` of the cell ``kimi_k2.docs_zh``, and the metric
``spliced_han_share``: the published shapes, the catalog's model config
copied whole, a seeded pool of Unicode 15.0 characters, a stand-in sample
within the published ranks, the mix's documents and sub-documents,
canned readings, and a sound CPU run that is correct."""

import json
import unicodedata
from pathlib import Path
from types import SimpleNamespace

import pytest

from tdbench import run, standin
from tdbench.byname import load
from test_tdbench_pretok_scripts import KIMI_PAT
from test_tdbench_run import small

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
# Kimi-K2-Instruct's config.json
# (https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json)
MODEL_CONFIG = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 7168, "intermediate_size": 18432, "kv_lora_rank": 512,
    "max_position_embeddings": 131072, "model_type": "kimi_k2",
    "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 384, "n_shared_experts": 1, "norm_topk_prob": True,
    "num_attention_heads": 64, "num_experts_per_tok": 8,
    "num_hidden_layers": 61, "num_key_value_heads": 64,
    "num_nextn_predict_layers": 0, "q_lora_rank": 1536,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_theta": 50000, "routed_scaling_factor": 2.827,
    "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32,
                     "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "scoring_func": "sigmoid", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "noaux_tc", "v_head_dim": 128,
    "vocab_size": 163840,
}


def config() -> dict:
    return json.loads((HERE / "configs" / "kimi_k2.json").read_text())


def test_published_shapes():
    c = config()
    assert c["pat_str"] == KIMI_PAT
    assert c["n_mergeable_ranks"] == 163584
    sp = c["special_tokens"]
    assert sorted(sp.values()) == list(range(163584, 163840))
    assert (sp["[BOS]"], sp["[EOS]"], sp["<|im_end|>"]) == (
        163584, 163585, 163586)
    assert all(sp[f"<|reserved_token_{i}|>"] == i
               for i in range(163587, 163840))
    assert c["vocab_size"] == c["n_mergeable_ranks"] + len(sp)
    assert set(c["assumed"]["sample_bytes"]) == {"prose", "code", "zh"}


def test_the_model_config_is_copied_whole():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == "kimi_k2")
    assert entry["source"] == (
        "https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/"
        "config.json")
    assert entry["reduced"] == []
    c = config()
    for k, v in MODEL_CONFIG.items():
        assert c[k] == v, k


@pytest.mark.parametrize("seed", [0, 2**31 + 99])
def test_zh_pool_is_seeded_and_assigned(seed):
    zh = load("pools", "zh")
    a = zh.make(1 << 16, seed)
    assert a == zh.make(1 << 16, seed) != zh.make(1 << 16, seed + 1)
    # blocks are cut at bytes, and a char split at a cut is dropped
    assert 0.99 * (1 << 16) <= len(a.encode()) <= 1 << 16
    assert all(unicodedata.category(ch) != "Cn" for ch in set(a))
    han = sum(3 for ch in a if "一" <= ch <= "鿿")
    assert han > len(a.encode()) // 2   # three blocks in four are Chinese
    assert "，" in a and "\n\n" in a and any(ch.isascii() and ch.isalpha()
                                             for ch in a)


def test_the_sample_stays_within_the_published_ranks():
    """The full stand-in: the sample's prefixes fill less than the
    published count (standin_ranks raises past it)."""
    ranks = standin.standin_ranks(config(), 2**31 + 5)
    assert len(ranks) == 163584
    assert len(set(ranks.values())) == 163584


def test_docs_zh_mix():
    """32 documents of log-uniform 32 KB-1 MB, 9,374,608 bytes in all,
    each cut into sub-documents of about 256 KB joined by [EOS]; every
    document is in the traced slice."""
    from tdbench import traffic

    _, cell, _, mix = run.load_cell("kimi_k2.docs_zh")
    assert (cell["config"], cell["chips"]) == ("kimi_k2", 1)
    assert (mix["call"], mix["loop"], mix["pool"]) == (
        "encode", "closed", "zh")
    assert mix["forms"] == [
        {"name": "between", "token": "[EOS]", "every": 262144}]
    lens = traffic.sizes(mix["sizes"])
    assert (len(lens), sum(lens), min(lens) >= 32768,
            max(lens) <= 1 << 20) == (32, 9374608, True, True)
    assert (mix["trace_units"], mix["check_share"]) == (32, 0.05)


@pytest.mark.parametrize("stats,want", [
    ({"spliced_pieces": 200, "spliced_han": 150}, 75.0),
    ({"spliced_pieces": 10, "spliced_han": 0}, 0.0),
    ({"spliced_pieces": 0, "spliced_han": 0}, None),
    ({"spliced_pieces": 5}, None),
], ids=["share", "none-han", "nothing-spliced", "no-counter"])
def test_spliced_han_share(stats, want):
    got = load("metrics", "spliced_han_share").read(SimpleNamespace(
        stats=stats))
    assert got == want


def test_cpu_run_is_correct():
    """The cell at the small sizes of ``test_tdbench_run.small``, its zh
    sample kept: the port's plain versions on the CPU are correct, and
    Han misses were spliced."""
    mix, cfg = small("kimi_k2.docs_zh")
    cfg["assumed"]["sample_bytes"]["zh"] = 1 << 14
    res, _ = run.run_cell("kimi_k2.docs_zh", 2**31 + 99, 0.3, True,
                          device="cpu", mix=mix, config=cfg)
    assert res["correct"], res["check"]
    assert res["check"]["checked_calls"]["value"] >= 1
    share = res["metrics"]["spliced_han_share.code"]["value"]
    assert 0 < share <= 100

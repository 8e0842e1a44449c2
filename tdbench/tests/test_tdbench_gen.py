"""The generators: deterministic per seed, the same sizes for every seed."""

import json
from pathlib import Path

import pytest

from tdbench import standin, traffic
from tdbench.byname import load, names

HERE = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
BIG = 2**31 + 12345


def small(mix: dict, count: int = 12, high: int = 6000) -> dict:
    sizes = dict(mix["sizes"], count=count,
                 high=min(high, mix["sizes"]["high"]))
    sizes["low"] = min(sizes["low"], sizes["high"])
    return dict(mix, sizes=sizes)


@pytest.mark.parametrize("pool", names("pools"))
def test_pools_are_seeded(pool):
    make = load("pools", pool).make
    assert make(20000, BIG) == make(20000, BIG)
    assert make(20000, BIG) != make(20000, BIG + 1)
    assert 19000 <= len(make(20000, 3).encode()) <= 20000


@pytest.mark.parametrize("name", MIXES)
def test_units_are_seeded(name):
    mix = small(json.loads((HERE / "traffic" / f"{name}.json").read_text()))
    a = traffic.make_units(mix, BIG)
    assert a == traffic.make_units(mix, BIG)
    b = traffic.make_units(mix, 7)
    assert a != b
    assert len(a) == len(b)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes(name):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    lens = traffic.sizes(mix["sizes"])
    assert lens == traffic.sizes(mix["sizes"])
    assert len(lens) == mix["sizes"]["count"]
    assert min(lens) >= mix["sizes"]["low"]
    assert max(lens) <= mix["sizes"]["high"]


def test_specials_land_as_the_mix_says():
    code = small(json.loads((HERE / "traffic" / "code.json").read_text()))
    units = traffic.make_units(code, 3)
    assert sum("<|fim_prefix|>" in u for u in units) == 3  # every 4th of 12
    prompts = small(json.loads((HERE / "traffic" / "prompts.json")
                               .read_text()))
    assert all(u.endswith("<|endofprompt|>") for u in
               traffic.make_units(prompts, 3))
    docs = small(json.loads((HERE / "traffic" / "docs.json").read_text()),
                 count=2, high=1 << 20)
    docs["sizes"]["low"] = 1 << 20
    for u in traffic.make_units(docs, 3):
        assert 3 <= u.count("<|endoftext|>") <= 5  # ~256 KB apart


def test_spread_picks_smallest_and_largest():
    sizes = [5, 1, 4, 2, 3]
    assert traffic.spread(sizes, 2) == [1, 0]
    assert sorted(traffic.spread(sizes, 9)) == list(range(5))


def test_warmup_takes_one_unit_of_each_octave():
    sizes = [100, 3000, 130, 70, 5000, 2100, 64]
    # the largest of [64, 128), [128, 256), [2048, 4096), [4096, 8192)
    assert traffic.warmup(sizes) == [0, 2, 1, 4]
    assert sorted(traffic.warmup([64, 127, 128, 255, 256])) == [1, 3, 4]


@pytest.mark.parametrize("name", MIXES)
def test_every_part_a_mix_names_is_a_file(name):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    assert mix["call"] in names("calls")
    assert mix["loop"] in names("loops")
    assert mix["pool"] in names("pools")
    for form in mix.get("forms", []):
        assert form["name"] in names("forms")


def test_standin_is_seeded_and_full():
    config = json.loads((HERE / "configs" / "cl100k.json").read_text())
    config = dict(config, n_mergeable_ranks=30000, assumed=dict(
        config["assumed"], sample_bytes={"prose": 1 << 16, "code": 1 << 14}))
    a = standin.standin_ranks(config, BIG)
    assert a == standin.standin_ranks(config, BIG)
    assert a != standin.standin_ranks(config, BIG + 1)
    assert len(a) == 30000 and sorted(a.values()) == list(range(30000))
    assert all(a[bytes([i])] == i for i in range(256))

"""The reference pretokenizer's Han script and class intersection
(``reference/pretok``, ``reference/scripts``): Kimi K2's published pattern
split as ``regex`` V1 splits it and encoded as tiktoken encodes it, the
frozen Han table against both engines, the forms it refuses, and the
translation, stand-in vocabulary and ids of the configurations that name
neither, unchanged."""

import hashlib
import json
import unicodedata
import warnings
from pathlib import Path

import numpy as np
import pytest

from tdbench import run, standin
from tdbench.byname import load
from tdbench.reference import pretok
from tdbench.reference.control import AsProgram
from tdbench.reference.encode import Reference
from tdbench.reference.scripts import HAN
from tdbench.textgen import SCRIPT_WORDS, WORDS
from test_tdbench_run import small

HERE = Path(__file__).resolve().parents[1]

# Kimi K2's pat_str, as tokenization_kimi.py builds it
# (https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/tokenization_kimi.py)
KIMI_PAT = "|".join([
    r"[\p{Han}]+",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]*"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]+"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"\p{N}{1,3}",
    r" ?[^\s\p{L}\p{N}]+[\r\n]*",
    r"\s*[\r\n]+",
    r"\s+(?!\S)",
    r"\s+",
])

# the port's GPT2_PATTERN and TEKKEN_PATTERN, copied as literals
GPT2_PAT = (r"'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
            r"|\s+(?!\S)|\s+")
TEKKEN_PAT = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
    r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# sha256 of the parent's outputs, before the reference read scripts
TRANSLATE_SHA = {
    "o200k": "68d0078821353455a5faf1e52e7184338caae54072cb69a916a9099990ba9750",
    "cl100k": "99ffcf5ce808db9b8727fe748e1f0a454aaadfd53c3072b3225012bec9e47d6a",
    "gpt2": "445734520a78947019f1743b70140819df0c3769d271099a3bb642d45315e2f4",
    "tekken": "dccd5c11d1bdc98f0ef2db19dcb734356cee9f7fd617fd6defcd678eb3f2143e",
}
STANDIN_SHA = {
    ("o200k", 5):
    "59e38dfadcab4e3de8fa3e6e568a0cdff9979b500aede41e0f44d92acce83aa4",
    ("o200k", 2**31 + 99):
    "65d1a9cadb22ad21a5d065be0071e092221afcbb5e3c69d151169f8dc0f063fc",
    ("cl100k", 5):
    "7ae2deb725993f817b92c5a62f1d490680216ebc790cd4521bb10b3f4ed9040e",
    ("cl100k", 2**31 + 99):
    "0fb45f2de6b37cc540e1905b2aa695dd9edd5e2054c0cf8d4d071c51bcf9a91d",
}
IDS_SHA = {
    "o200k": "bc8e53f6ae3eaef827a77da8bdad96a992ebbd47796827af90cceeeb77494acb",
    "cl100k": "a046a28f6da9e4c121005309a49af571008c2bb15137ac3e98d9c72e8b59e97d",
}


@pytest.fixture(scope="module")
def regex():
    return pytest.importorskip("regex")


@pytest.fixture(scope="module")
def tiktoken():
    return pytest.importorskip("tiktoken")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def small_config(name: str) -> dict:
    """The configuration at the sizes of ``test_tdbench_run.small``."""
    return small({"o200k": "o200k.docs", "cl100k": "cl100k.code"}[name])[1]


def assigned(a: int, b: int) -> list[str]:
    """The characters of U+a..U+b that Unicode 15.0 assigns."""
    return [chr(c) for c in range(a, b + 1)
            if unicodedata.category(chr(c)) != "Cn"]


# what Han-heavy text is drawn from (Unicode 15.0 assignments only)
HAN_RUNS = [  # (characters, weight)
    (assigned(0x4E00, 0x9FFF), 70),        # CJK Unified Ideographs
    (assigned(0x3400, 0x4DBF), 10),        # Extension A
    (assigned(0x20000, 0x2A6DF), 10),      # Extension B
    (assigned(0x2A700, 0x323AF), 5),       # Extensions C-H, compat. supp.
    (assigned(0xF900, 0xFAD9), 3),         # compatibility ideographs
    (list("々〇〻〡〢〸\U00016fe2\U00016fe3\U00016ff0\U00016ff1"), 2),
]
OTHER_RUNS = [  # (characters, longest run)
    (assigned(0x2E80, 0x2FD5), 3),         # radicals (So, Han)
    (list("，。！？：；（）「」『』、・…—～＂＇"), 2),  # fullwidth punctuation
    (assigned(0xFF21, 0xFF3A) + assigned(0xFF41, 0xFF5A), 8),
    (assigned(0xFF10, 0xFF19), 6),         # fullwidth digits
    (assigned(0x3041, 0x3096) + list("ゝゞ"), 8),   # hiragana
    (assigned(0x30A1, 0x30FA) + list("ー"), 8),      # katakana
    (assigned(0xAC00, 0xD7A3), 5),         # Hangul
    (list("0123456789"), 7),
    (assigned(0x17000, 0x187F7), 4),       # Tangut (Lo, not Han)
    (assigned(0x1D400, 0x1D6A5), 6),       # mathematical letters
    (assigned(0x1D7CE, 0x1D7FF), 4),       # mathematical digits
    (assigned(0x1F600, 0x1F64F), 2),       # emoji
    (list("\u302a\u0301\u0308"), 1),    # combining marks
]
SEPARATORS = ["", "", "", " ", " ", "  ", "\n", "\r\n", "\t", "\u3000",
              ", ", "'s", "'LL", "'t ", " 12"]


def han_text(n_bytes: int, seed: int) -> str:
    """About n_bytes of seeded text: the multi-script words of the
    benchmark's pools, and Han runs beside kana, Hangul, fullwidth forms,
    radicals, supplementary letters and digits, often with no space."""
    rng = np.random.default_rng(seed)
    words = WORDS + SCRIPT_WORDS
    weights = np.array([w for _, w in HAN_RUNS], float)
    parts, size = [], 0
    while size < n_bytes:
        n = 4096
        kind = rng.integers(0, 4, n).tolist()
        lens = rng.integers(1, 41, n).tolist()
        which = rng.choice(len(HAN_RUNS), size=(n, 40),
                           p=weights / weights.sum()).tolist()
        draw = rng.random((n, 40)).tolist()
        other = rng.integers(len(OTHER_RUNS), size=n).tolist()
        word = rng.integers(len(words), size=n).tolist()
        sep = rng.integers(len(SEPARATORS), size=n).tolist()
        for i in range(n):
            if kind[i] <= 1:        # a Han run
                s = "".join(
                    HAN_RUNS[w][0][int(d * len(HAN_RUNS[w][0]))]
                    for w, d in zip(which[i][:lens[i]], draw[i]))
            elif kind[i] == 2:
                chars, longest = OTHER_RUNS[other[i]]
                s = "".join(chars[int(d * len(chars))]
                            for d in draw[i][:1 + lens[i] % longest])
            else:
                s = words[word[i]]
            s += SEPARATORS[sep[i]]
            parts.append(s)
            size += len(s.encode())
    return "".join(parts)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**32 + 7])
def test_kimi_split_equals_regex_v1(regex, seed):
    text = han_text(1 << 20, seed)
    assert len(text.encode()) >= 1 << 20
    present = set(text)
    assert {"々", "〇", "ー", "，", "\U00016fe2"} <= present
    for lo, hi in ((0x20000, 0x2A6DF), (0x2E80, 0x2FD5), (0xAC00, 0xD7A3),
                   (0x17000, 0x187F7)):    # Ext B, radicals, Hangul, Tangut
        assert any(lo <= ord(c) <= hi for c in present), hex(lo)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = pretok.split(KIMI_PAT, text)
    assert got == regex.compile(KIMI_PAT, regex.V1).findall(text)


@pytest.mark.parametrize("pat", [
    r"[a-z&&[^aeiou]]+",
    r"[^a-z&&[aeiou]]+",
    r"[\p{L}&&[\p{Lu}]]+|\s+",
    r"[\p{L}\p{N}&&[^\p{Han}]]+",
    r"[\s&&[^\n]]+",
    r"[\p{Lo}&&[\p{Han}]]+|[\p{Lo}]+",
    r"[\p{Han}\p{N}]+|[^\p{Han}]",
], ids=["consonants", "negated-outer", "upper", "no-han", "space-no-nl",
        "han-lo", "han-union"])
def test_intersection_equals_regex_v1(regex, pat):
    text = han_text(1 << 16, 5)
    assert pretok.split(pat, text) == regex.compile(pat, regex.V1).findall(
        text)


def test_han_table_equals_regex(regex):
    han = regex.compile(r"\p{Han}")
    want = [cp for cp in range(0x110000)
            if unicodedata.category(chr(cp)) != "Cn" and han.match(chr(cp))]
    got = [cp for a, b in HAN for cp in range(a, b + 1)]
    assert got == want
    assert len(got) == 98408


def test_han_table_equals_tiktoken(tiktoken):
    """tiktoken's ``\\p{Han}`` over the code points Unicode 15.0 assigns:
    a piece that is whole in the ranks is one id, so U+4E00 followed by a
    Han character is one id and by any other character two."""
    cands = [cp for cp in range(0x110000)
             if unicodedata.category(chr(cp)) not in ("Cn", "Cs", "Co")]
    ranks = {bytes([b]): b for b in range(256)}
    for cp in cands:
        ranks[("\u4e00" + chr(cp)).encode()] = len(ranks)
    enc = tiktoken.Encoding("han", pat_str=r"[\p{Han}]+|[^\p{Han}]",
                            mergeable_ranks=ranks, special_tokens={})
    want = [cp for cp in cands
            if len(enc.encode_ordinary("\u4e00" + chr(cp))) == 1]
    assert [cp for a, b in HAN for cp in range(a, b + 1)] == want
    # Script, not Script_Extensions: CJK punctuation is not Han
    assert not {0x3001, 0x3002, 0x300C, 0x30FB} & set(want)


def test_han_stand_ins_part_han_from_other_letters():
    """A supplementary Han Lo and a Tangut Lo map to different stand-ins
    where the pattern names Han, and to the Lo stand-in where it does
    not."""
    han_lo, tangut = "\U00020000", "\U00017000"
    assert pretok.split(r"[\p{Han}]+|\p{L}+", han_lo + tangut) == [
        han_lo, tangut]
    assert pretok.split(r"\p{Lo}+", han_lo + tangut) == [han_lo + tangut]


@pytest.mark.parametrize("pat", [
    r"[a--b]", r"[a||b]", r"[a~~b]",
    r"[a[b]]", r"[[a]&&[b]]",
    r"a&&b",
    r"[a&&[b&&[c]]]", r"[a&&[[b]]]",
    r"\p{Greek}", r"[\p{Latin}]", r"\P{L}", r"\p{Script=Han}",
    r"[a&&b]", r"[&&[b]]", r"[a&&[b]c]", r"[a&&[]]", r"[a&&[b]",
    r"(?i:[a-z&&[^b]])", r"(?i)[a-z&&[^b]]",
    r"[\U00020000-\U0002A6DF&&[^\p{Han}]]", "[\\p{L}\U00020000&&[\\p{Lo}]]",
    r"[\p{L}&&[^\U0001D400]]", r"[\uFF00-\U00010010&&[\p{L}]]",
], ids=["difference", "union", "symmetric", "bracket", "bracket-first",
        "outside", "deeper", "double-bracket", "greek", "latin", "negated",
        "script-eq", "no-nested", "empty-left", "after-nested",
        "empty-nested", "unclosed", "ignore-case", "global-ignore-case",
        "supplementary-range", "supplementary-literal",
        "supplementary-nested", "range-past-bmp"])
def test_refused_forms_raise(pat):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError):
            pretok.translate(pat)


def test_case_insensitive_group_ends_where_it_closes(regex):
    pat = r"(?i:'s)|[a-z&&[^aeiou]]+"
    assert pretok.split(pat, "it's bcd") == regex.compile(
        pat, regex.V1).findall("it's bcd")


@pytest.mark.parametrize("name", sorted(TRANSLATE_SHA))
def test_translate_unchanged(name):
    pat = {"gpt2": GPT2_PAT, "tekken": TEKKEN_PAT}.get(name) or config(
        name)["pat_str"]
    got = pretok.translate(pat).encode("utf-8", "surrogatepass")
    assert hashlib.sha256(got).hexdigest() == TRANSLATE_SHA[name]


def ranks_sha(ranks: dict[bytes, int]) -> str:
    h = hashlib.sha256()
    for tok, r in ranks.items():
        h.update(r.to_bytes(4, "little") + len(tok).to_bytes(2, "little")
                 + tok)
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(STANDIN_SHA))
def test_standin_ranks_unchanged(name, seed):
    ranks = standin.standin_ranks(small_config(name), seed)
    assert ranks_sha(ranks) == STANDIN_SHA[(name, seed)]


@pytest.mark.parametrize("name", sorted(IDS_SHA))
def test_reference_ids_unchanged(name):
    cfg = small_config(name)
    ranks = standin.standin_ranks(cfg, 5)
    ref = Reference(cfg["pat_str"], ranks, cfg["special_tokens"])
    text = "".join(load("pools", p).make(1 << 16, 9)
                   for p in ("prose", "code"))
    text += "".join(cfg["special_tokens"])
    text += "x\U0001d400\U00020000\U00017000 \U0001d7ce"
    ids = ref.encode(text)
    assert hashlib.sha256(json.dumps(ids).encode()).hexdigest() == (
        IDS_SHA[name])


# Kimi K2's shape at a test's size: its pat_str, 20,000 stand-in ranks and
# three of its specials (ids as in its tokenizer_config.json)
KIMI_CONFIG = {
    "name": "kimi_k2",
    "pat_str": KIMI_PAT,
    "n_mergeable_ranks": 20000,
    "special_tokens": {"[BOS]": 163584, "[EOS]": 163585,
                       "<|im_end|>": 163586},
    "assumed": {"sample_bytes": {"prose": 1 << 16, "code": 1 << 13}},
}


class RegexSplit(Reference):
    """The reference's merge over a split by a compiled ``regex``."""

    def __init__(self, pat_str, ranks, specials, compiled):
        super().__init__(pat_str, ranks, specials)
        self.compiled = compiled

    def encode_ordinary(self, text: str) -> list[int]:
        out: list[int] = []
        for p in self.compiled.findall(text):
            out.extend(self.encode_piece(p.encode("utf-8")))
        return out


def kimi_run(compiled) -> dict:
    mix = small("o200k.docs")[0]
    mix["forms"] = [dict(f, token="[EOS]") if f["name"] == "between" else f
                    for f in mix["forms"]]
    return run.run_cell(
        "o200k.docs", 2**31 + 99, 0.3, False, device="cpu", mix=mix,
        config=KIMI_CONFIG,
        program=lambda pat, ranks, specials: AsProgram(
            RegexSplit(pat, ranks, specials, compiled)))[0]


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**32 + 7])
def test_kimi_reference_equals_tiktoken(tiktoken, seed):
    """The reference's ids for Kimi K2's pattern are tiktoken's, over the
    same stand-in ranks and specials, on the Han-heavy text."""
    ranks = standin.standin_ranks(KIMI_CONFIG, seed)
    specials = KIMI_CONFIG["special_tokens"]
    enc = tiktoken.Encoding("kimi", pat_str=KIMI_PAT, mergeable_ranks=ranks,
                            special_tokens=specials)
    text = han_text(1 << 20, seed)
    third = len(text) // 3
    text = (text[:third] + "[BOS]" + text[third:2 * third] + "<|im_end|>"
            + text[2 * third:] + "[EOS]")
    ref = Reference(KIMI_PAT, ranks, specials)
    assert ref.encode(text) == enc.encode(text, allowed_special="all")


def test_kimi_run_honest_program_is_correct(regex):
    res = kimi_run(regex.compile(KIMI_PAT, regex.V1))
    assert res["correct"], res["check"]
    assert res["check"]["checked_calls"]["value"] >= 1


def test_kimi_run_regex_v0_program_is_not_correct(regex):
    """``regex``'s default version reads ``&&`` as literal characters and
    drops every Latin word: the reference must see it."""
    res = kimi_run(regex.compile(KIMI_PAT, regex.V0))
    assert not res["correct"]
    assert res["check"]["wrong_calls"]["value"] > 0

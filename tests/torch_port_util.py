"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py):
seeded ASCII text built to fire every class rule of the piece-start
derivation, seeded multi-script text, and both staged into fixed-shape
byte windows with garbage tails."""

import numpy as np

_POOLS = [
    [chr(c) for c in range(0x20, 0x7F)],
    [" ", "\t", "\n", "\r", " ", " ", "\x0c", "\x0b", "  ", "   "],
    ["'s", "'T", "'re", "'Ve", "'ll", "'d", "'", "'M", "'D", "'S"],
    ["A", "z", "5", "/", "\r\n", "123", "4567", "//", "...", "!?", "\n\n"],
    ["the", "The", " the", "HTTPServer", "camelCase", "don't", " I'm",
     "x1y2", "WON'T", "o'clock", " 99999", "a//b", "  \n  x"],
]


def ascii_text(rng: np.random.Generator, n: int) -> str:
    """About n chars of class-adversarial ASCII text."""
    parts, size = [], 0
    while size < n:
        pool = _POOLS[int(rng.integers(len(_POOLS)))]
        s = pool[int(rng.integers(len(pool)))]
        parts.append(s)
        size += len(s)
    return "".join(parts)[:n]


_WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an they you were her she all would there "
    "hello world tell well still never"
).split()


def prose_text(rng: np.random.Generator, n: int) -> str:
    """About n chars of English-like ASCII prose with digits, code and
    contractions (~4-5 bytes per piece, so 1/3-byte capacities hold)."""
    parts, size = [], 0
    while size < n:
        k = int(rng.integers(6, 20))
        words = [_WORDS[int(i)] for i in rng.integers(len(_WORDS), size=k)]
        words[0] = words[0].capitalize()
        s = " ".join(words)
        r = rng.random()
        if r < 0.1:
            s += f" {int(rng.integers(0, 10**6))}"
        elif r < 0.2:
            s += " don't it's they'll"
        elif r < 0.25:
            s += "\n    def f(x):\n        return x**2\n"
        s += [". ", "! ", "? ", ".\n\n"][int(rng.integers(4))]
        parts.append(s)
        size += len(s)
    return "".join(parts)[:n]


def stage(texts, n: int, rng: np.random.Generator):
    """(B, n) uint8 windows holding ``texts`` (UTF-8, cut at n bytes) then
    random garbage bytes (including values >= 128), and their (B,) int32
    lengths."""
    by = rng.integers(0, 256, (len(texts), n)).astype(np.uint8)
    nb = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        raw = t.encode("utf-8")[:n]
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return by, nb


def collision_vocab(seed: int = 0, n_total: int = 3000):
    """Ranks over all 256 bytes plus random 2-16 byte tokens, of which 12
    share one vhash8 bucket, so the 8-slot table must drop some: the
    deliberate false misses the host splice resolves."""
    from tokendagger_tpu_torch.tables import _mix_hash, _vhash_ab, vocab_keys

    rng = np.random.default_rng(seed)
    ranks = {bytes([i]): i for i in range(256)}
    cands = set()
    while len(cands) < 20 * n_total:
        k = int(rng.integers(2, 17))
        cands.add(bytes(rng.integers(32, 127, k).astype(np.uint8)))
    cands = sorted(cands)
    # the short-token count fixes the bucket count (tables._build_vocab_hash8)
    n_short = n_total
    mask = (1 << max(10, int(np.ceil(np.log2(n_short / 1.5))))) - 1
    keys, lens, _ = vocab_keys({c: 0 for c in cands})
    a, b = _vhash_ab(keys[:, 0], keys[:, 1], keys[:, 2], keys[:, 3], lens)
    h = _mix_hash(a, b, 0, mask)
    bucket = np.bincount(h).argmax()
    crowd = [cands[i] for i in np.flatnonzero(h == bucket)[:12]]
    rest = [cands[i] for i in rng.permutation(len(cands))
            if cands[i] not in crowd]
    for tok in crowd + rest[: n_total - 256 - len(crowd)]:
        ranks[tok] = len(ranks)
    return ranks, crowd


# Multi-script pieces: Latin accents, Greek, Cyrillic, CJK, Arabic, emoji
# (with ZWJ and skin tone), U+3000, combining marks, the fold letters
# U+017F (long s) and U+212A (Kelvin) after apostrophes, and ASCII.
_SCRIPTS = [
    ["café", "naïve", "Übermäßig", "schön", "Ça", "résumé", "ÉCOLE", "ǅemal"],
    ["Γειά", "σου", "Κόσμε", "ΑΘΗΝΑ", "λόγος"],
    ["Здравствуйте", "мир", "МОСКВА", "ёлка"],
    ["日本語", "中文文本", "テキスト", "한국어", "の"],
    ["مرحبا", "שלום", "עולם"],
    ["🙂", "👩\u200d👩\u200d👧", "👍🏽", "🇺🇸", "🎉🎉"],
    ["\u3000", "\u3000\u3000", "\u00a0", "\u2028", " \u3000x"],
    ["e\u0301\u0302", "à", "\u0300x", "a\u0308"],
    ["'\u017f", "'\u212a", "I'\u017fT", "x'\u017f\u017f", "'LL", "'ſ'ſ"],
    ["12", "٣٤", "²³", "Ⅻ", "3.14"],
]


def multiscript_text(rng: np.random.Generator, n: int) -> str:
    """About n chars of seeded text that mixes scripts with the ASCII
    pools above."""
    parts, size = [], 0
    while size < n:
        if rng.random() < 0.4:
            pool = _POOLS[int(rng.integers(len(_POOLS)))]
        else:
            pool = _SCRIPTS[int(rng.integers(len(_SCRIPTS)))]
        s = pool[int(rng.integers(len(pool)))]
        if rng.random() < 0.3:
            s = " " + s
        parts.append(s)
        size += len(s)
    return "".join(parts)[:n]


def invalid_utf8(rng: np.random.Generator, n: int) -> bytes:
    """n bytes of valid multi-byte text laced with stray continuations,
    0xF5-0xFF leads and truncated sequences, ending in a truncated 4-byte
    sequence."""
    good = multiscript_text(rng, n).encode("utf-8")
    out = bytearray(good[: n - 3])
    for i in rng.integers(0, len(out), max(1, len(out) // 50)):
        out[int(i)] = int(rng.choice([0x80, 0xBF, 0xC3, 0xE2, 0xF0, 0xF5,
                                      0xF8, 0xFE, 0xFF]))
    return bytes(out) + b"\xf0\x9f\x99"

"""The one generator of traffic: a mix file of parameters -> units.

A traffic mix is ``traffic/<name>.json``. A *unit* is what one call of the
API takes. Keys:

* ``call``, ``loop``: the files ``calls/<call>.py`` (the API call a unit
  makes, and the reference's answer to it) and ``loops/<loop>.py`` (how
  the window drives the calls).
* ``pool``: the text maker ``pools/<pool>.py`` the texts are cut from.
* ``sizes``: the texts' byte lengths, the same for every seed: the
  ``count`` quantiles, at (i + 0.5) / count, of ``log_uniform`` over
  [``low``, ``high``] or of ``log_normal`` (``median``, ``sigma``), clipped
  to [``low``, ``high``].
* ``forms``: what is done to the texts, in order, each ``forms/<name>.py``
  with its own parameters (chat turns, special tokens placed).
* ``trace_units``: the units the traced slice runs (``spread``).
* ``check_share``: the share of the window's further calls, drawn from the
  seed, whose ids are compared with the reference, besides the first call
  of each unit.

The seed draws the text, the forms' offsets and the order of the units;
the sizes do not depend on it, so every seed gives the same work.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

from .byname import load
from .seeds import sub_seed
from .textgen import cut


def sizes(spec: dict) -> list[int]:
    n, lo, hi = int(spec["count"]), int(spec["low"]), int(spec["high"])
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "log_uniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    elif spec["dist"] == "log_normal":
        norm = statistics.NormalDist(math.log(spec["median"]), spec["sigma"])
        vals = [math.exp(norm.inv_cdf(q)) for q in qs]
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(v))) for v in vals]


def make_units(mix: dict, seed: int) -> list:
    """The mix's units, in the seed's order."""
    lens = sizes(mix["sizes"])
    pool = load("pools", mix["pool"]).make(sum(lens) + (1 << 16),
                                           sub_seed(seed, 20)).encode()
    starts = np.cumsum([0] + lens[:-1]).tolist()
    texts = [cut(pool[a:a + k], k) for a, k in zip(starts, lens)]
    for form in mix.get("forms", []):
        texts = load("forms", form["name"]).apply(texts, form, seed)
    order = np.random.default_rng(sub_seed(seed, 22)).permutation(len(texts))
    return [texts[i] for i in order.tolist()]


def by_size(unit_bytes: list[int]) -> list[int]:
    return sorted(range(len(unit_bytes)), key=lambda i: (unit_bytes[i], i))


def spread(unit_bytes: list[int], k: int) -> list[int]:
    """Indices of ``k`` units evenly spaced over the units ordered by
    size, the smallest and the largest among them (all when k >= len)."""
    order = by_size(unit_bytes)
    if k >= len(order):
        return order
    if k == 1:
        return [order[len(order) // 2]]
    return [order[round(j * (len(order) - 1) / (k - 1))] for j in range(k)]


def warmup(unit_bytes: list[int]) -> list[int]:
    """One unit of each octave of size (the largest of it): every shape
    a call picks by its input's size, each once."""
    last = {}
    for i in by_size(unit_bytes):
        last[max(unit_bytes[i], 1).bit_length()] = i
    return list(last.values())

"""Command line: encode text / run a quick benchmark.

    python -m tokendagger_tpu_torch.cli encode --model tokenizer.model \
        --config tokenizer_config.json --text "hello world"
    python -m tokendagger_tpu_torch.cli bench --model tokenizer.model

``--backend`` is "auto", "host" or "device" and ``--device`` the device
the device engine runs on (default ``cuda``; ``cpu`` runs every kernel's
plain version).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .vocab import (
    LLAMA4_PATTERN, load_hf_special_tokens, load_tekken, load_tiktoken_model,
)
from .wrapper import Encoding, Tokenizer


def _build(args) -> Tokenizer:
    kw = dict(backend=args.backend, device=args.device)
    if args.tekken:
        cfg = load_tekken(args.tekken)
        return Encoding("tekken", pat_str=cfg["pattern"],
                        mergeable_ranks=cfg["mergeable_ranks"],
                        special_tokens=cfg["special_tokens"], **kw)
    ranks = load_tiktoken_model(args.model)
    specials = load_hf_special_tokens(args.config) if args.config else {}
    return Encoding("llama4", pat_str=args.pattern or LLAMA4_PATTERN,
                    mergeable_ranks=ranks, special_tokens=specials, **kw)


def cmd_encode(args) -> int:
    tok = _build(args)
    text = args.text if args.text is not None else sys.stdin.read()
    ids = tok.encode(text,
                     allowed_special="all" if args.allow_special else set())
    print(json.dumps(ids))
    return 0


def cmd_bench(args) -> int:
    """Timing loop: warm-ups, then timed iterations of an ordinary encode
    of one prompt; prints avg/min/max µs (host clock, each call returns
    its ids to the host)."""
    tok = _build(args)
    prompt = args.text or "This is a test prompt for the tokenizer benchmark."
    for _ in range(args.warmup):
        tok.encode_ordinary(prompt)
    times = []
    ids: list[int] = []
    for _ in range(args.iterations):
        t0 = time.perf_counter_ns()
        ids = tok.encode_ordinary(prompt)
        times.append(time.perf_counter_ns() - t0)
    print(json.dumps({
        "iterations": args.iterations,
        "tokens": len(ids),
        "backend": args.backend,
        "device": args.device,
        "avg_us": round(sum(times) / len(times) / 1e3, 2),
        "min_us": round(min(times) / 1e3, 2),
        "max_us": round(max(times) / 1e3, 2),
    }))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tokendagger_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in [("encode", cmd_encode), ("bench", cmd_bench)]:
        p = sub.add_parser(name)
        p.add_argument("--model", type=Path, help="tiktoken .model file")
        p.add_argument("--config", type=Path, help="HF tokenizer_config.json")
        p.add_argument("--tekken", type=Path, help="Mistral tekken.json")
        p.add_argument("--pattern", help="override split pattern")
        p.add_argument("--backend", default="auto",
                       choices=["auto", "host", "device"])
        p.add_argument("--device", default="cuda",
                       help="device of the device engine (cuda, cuda:N, cpu)")
        p.add_argument("--text")
        p.add_argument("--allow-special", action="store_true",
                       dest="allow_special")
        p.set_defaults(fn=fn)
    b = sub.choices["bench"]
    b.add_argument("--warmup", type=int, default=5)
    b.add_argument("--iterations", type=int, default=10000)
    args = ap.parse_args(argv)
    if not args.tekken and not args.model:
        ap.error("--model or --tekken required")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""PyTorch/CUDA port of tokendagger_tpu.

A tiktoken-compatible BPE tokenizer whose device path turns raw byte
windows into exact token ids. This package holds the port of the public
API (``Tokenizer``/``Encoding`` over ``DeviceEngine``, safe-cut windows
over any UTF-8 text), of the ASCII corpus pipeline (``ResidentStream``)
and of the window-batch harness ``run_resident`` with its general
(multi-byte) pipeline: plain torch for the table probe, the decode and the
glue, hand-written CUDA kernels for Hopper (``csrc/``) where the JAX
package has Pallas kernels. Entry points run on the card unless the
caller passes ``device="cpu"`` (or ``backend="host"``); on CPU tensors
every kernel's wrapper runs its plain torch version instead.
"""

from .engine import DeviceEngine, EngineStats
from .hostengine import HostEngine, byte_pair_encode, byte_pair_merge
from .resident import ResidentResult, run_resident
from .residentstream import ResidentStream, StreamStats
from .vocab import (
    CL100K_PATTERN,
    GPT2_PATTERN,
    LLAMA4_PATTERN,
    classify_pattern,
    load_hf_special_tokens,
    load_tiktoken_model,
)
from .wrapper import (
    Encoding,
    TokenDaggerError,
    Tokenizer,
    create_tokenizer,
    load_tokenizer,
)

__all__ = [
    "CL100K_PATTERN",
    "DeviceEngine",
    "Encoding",
    "EngineStats",
    "GPT2_PATTERN",
    "HostEngine",
    "LLAMA4_PATTERN",
    "ResidentResult",
    "ResidentStream",
    "StreamStats",
    "TokenDaggerError",
    "Tokenizer",
    "byte_pair_encode",
    "byte_pair_merge",
    "classify_pattern",
    "create_tokenizer",
    "load_hf_special_tokens",
    "load_tiktoken_model",
    "load_tokenizer",
    "run_resident",
]

"""Embedding models — the replacement for the reference's L1
(reference: src/llm/ — ``LlmService`` trait + ONNX ``HfService``).

The reference runs ``nomic-embed-text-v1.5`` through ONNX Runtime with one
model replica *per MPI process* (its memory bottleneck — OOM at N=32,
README.md:164-166). Here the encoder is a set of JAX functions jitted over a
device mesh: one weight replica per device (or sharded, under tensor parallelism),
fixed ``[B, 512]`` int32 batches for XLA compile-cache friendliness.
"""

from .encoder import EncoderService, create_encoder  # noqa: F401
from .hash_encoder import HashEncoder  # noqa: F401
from .nomic import NomicBertConfig, NomicEncoder, init_params  # noqa: F401
from .tokenizer import FixedLengthTokenizer, HashingTokenizer, load_tokenizer  # noqa: F401

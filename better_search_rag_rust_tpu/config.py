"""Configuration surface for the framework.

The reference hardcodes every knob as a compile-time constant or env var
(reference: src/main.rs:38-45 — ``extensions``, ``dir``, ``chunk_size``,
``top_k``, ``query_idx``, ``SKIP_PROCESS``; src/llm/hf.rs:9-10,62 — model path
and ``max_token_length=512``; src/main.rs:41 — vstore dir). Its README even
instructs users to "adjust the chunk size in main.rs". Here every knob is a
dataclass field with a CLI mapping (see :mod:`.cli`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# Default embedding dimensionality of nomic-embed-text-v1.5
# (reference: src/llm/hf.rs:118-123 — [B, 768] output).
DEFAULT_DIM = 768
# Fixed tokenization length (reference: src/llm/hf.rs:62 — max_token_length=512,
# PaddingStrategy::Fixed(512)). Fixed shapes are also what XLA wants.
DEFAULT_MAX_TOKENS = 512
# 10 MB file-read cap (reference: src/source.rs:36-39).
DEFAULT_MAX_FILE_BYTES = 10 * 1024 * 1024


@dataclass(frozen=True)
class CorpusConfig:
    """Which files to ingest (reference: src/main.rs:38-39, src/source.rs:8-49)."""

    root: str = ".repos/jabref"
    extensions: Tuple[str, ...] = ("java",)
    max_file_bytes: int = DEFAULT_MAX_FILE_BYTES
    #: Files per embedding batch ("chunk" in the reference = a batch of files,
    #: reference: src/main.rs:40, src/mpi_helpers/tasks.rs:80-83).
    files_per_batch: int = 32
    #: Max embedding batches dispatched to the device but not yet collected
    #: in the ingest pipeline (2 = dispatch i, collect i-1 — the classic
    #: double-buffer). Deeper values keep more forwards queued behind each
    #: synchronous readback; each extra slot holds one batch of file
    #: contents + one [B, D] device buffer in memory.
    inflight_batches: int = 2


@dataclass(frozen=True)
class EncoderConfig:
    """Embedding model spec (reference: src/llm/hf.rs).

    ``checkpoint_dir`` may point at a local HF-format export of
    ``nomic-ai/nomic-embed-text-v1.5`` (config.json + weights + tokenizer).
    When absent, the framework falls back to a deterministic hash encoder so
    the full pipeline stays runnable hermetically — mirroring the reference's
    artifact-gated model tests (src/llm/hf.rs:138-144).
    """

    name: str = "nomic-embed-text-v1.5"
    checkpoint_dir: Optional[str] = None
    dim: int = DEFAULT_DIM
    max_tokens: int = DEFAULT_MAX_TOKENS
    # NomicBERT architecture defaults (BERT-base sized backbone).
    vocab_size: int = 30528
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    type_vocab_size: int = 2
    rotary_base: float = 1000.0
    layer_norm_eps: float = 1e-12
    #: "swiglu" (NomicBERT) or "gelu" (classic BERT).
    activation: str = "swiglu"
    #: Mean pooling over the attention mask, then L2-normalize.
    pooling: str = "mean"
    #: Matryoshka truncation: keep the first ``matryoshka_dim`` dims and
    #: re-normalize (v1.5 is Matryoshka-trained). None = full ``dim``.
    matryoshka_dim: Optional[int] = None
    #: Compute dtype for the forward pass.
    dtype: str = "bfloat16"
    #: Attention implementation: "auto" resolves by platform (see
    #: ``models.nomic.resolve_attention_impl``): "cudnn" on a GPU (fused
    #: attention through ``jax.nn.dot_product_attention``), "xla" on the
    #: CPU. "xla_bf16" forces the bf16-logit XLA chain, "xla" full-f32
    #: logits (numerical parity checks pin this). The resolved impl is
    #: recorded in the store's encoder metadata and mismatches warn at
    #: serve time.
    attention_impl: str = "auto"
    #: Long-document handling: "truncate" keeps the reference's semantics
    #: (text beyond max_tokens is silently dropped, src/llm/hf.rs:62-67);
    #: "mean" splits the full token stream into fixed-shape windows, encodes
    #: every window and mean-pools per document (then re-normalizes).
    long_doc: str = "truncate"
    #: Batch size for the jitted forward (fixed shape for XLA cache hits).
    batch_size: int = 32
    #: "nomic" = the NomicBERT model (random-init unless checkpoint_dir is set),
    #: "hash" = deterministic hash encoder (hermetic tests/benches).
    backend: str = "auto"


@dataclass(frozen=True)
class StoreConfig:
    """Persistent vector store (reference: src/vectorstore/polars.rs, parquet
    shards ``rank_{r}.parquet`` merged into ``global.parquet`` —
    src/mpi_helpers/vectorstore.rs:5-20; here ``.npy`` matrices
    ``rank_{r}.npy`` merged into ``global.npy``)."""

    dir: str = ".volumes/vstore"
    #: On-disk dtype. float32 matches the reference's List<f32> column.
    dtype: str = "float32"
    #: Maintain a snapshot of the built DeviceStore next to the store and
    #: serve from it when fresh (skips normalize+pad+cast at startup; see
    #: store/device_cache.py).
    use_snapshot: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh topology. Replaces MPI world/rank/size
    (reference: src/main.rs:27-30).

    ``shape=None`` puts every visible device on the ``data`` axis — the
    device-mesh analogue of the reference's pure SPMD data parallelism
    (SURVEY.md §2 "Parallelism strategies").
    """

    shape: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class SearchConfig:
    """Exact top-k search (reference: src/mpi_helpers/metrics.rs:16-206)."""

    top_k: int = 50
    #: Index of the stored vector used as the self-retrieval query
    #: (reference: src/main.rs:110-111).
    query_idx: int = 0
    #: Store rows scanned per scan step on each device.
    chunk_rows: int = 16384
    #: Column-block size for the hierarchical (block-max) merge.
    row_block: int = 128
    #: dtype the store shards are held in on device: "bfloat16"
    #: (default — exact vs the bf16-rounded oracle), "float32" (exact vs
    #: the f32 oracle), or "int8" (symmetric lattice quantization, half of
    #: bf16's bytes; exact vs the integer oracle — see ops/quantize.py for
    #: the trade).
    store_dtype: str = "bfloat16"
    #: Per-device cap on the f32 similarity buffer of the dense kernel;
    #: shards bigger than it are scanned in macro chunks with a running
    #: top-k merge (q_tile stays wide — see ops.topk.global_topk).
    #: 0 = auto: free device memory minus 2 GB headroom, within 1-4 GB
    #: (fewer chunks = fewer per-chunk candidate gathers).
    sims_buffer_bytes: int = 0
    #: Search strategy: "global" (dense two-stage block selection — one
    #: matmul + one top-k per query tile, with macro chunking for shards
    #: larger than the sims budget), "scan" (chunked running top-k),
    #: "blockmax" (chunked hierarchical merge), or "auto" (= "global").
    #: Every strategy is exact against the oracle.
    kernel: str = "auto"
    #: Query upload dtype for the streaming/serving paths: "f32" uploads
    #: f32 queries and rounds to the store dtype ON DEVICE (the default,
    #: parity-pinned arithmetic); "store" normalizes + rounds on the HOST
    #: and uploads store-dtype bits — half the host->device bytes on bf16
    #: stores, a quarter on int8, the direct lever where the upload link
    #: bounds serving throughput. Both paths are exact against the oracle
    #: fed their own query bits (engine.prepare_upload_queries /
    #: oracle_topk(upload=)).
    query_upload: str = "f32"


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline (reference: src/main.rs:25-189)."""

    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    #: Skip ingest+embed and serve search from the persisted global store
    #: (reference: SKIP_PROCESS env, src/main.rs:42-45).
    skip_process: bool = False
    #: Resume a partially completed ingest from the shard's progress marker.
    #: The reference has no partial-progress resume at all (SURVEY.md §5
    #: "Checkpoint / resume": a crashed embed phase restarts from zero).
    resume: bool = False
    #: Persist the shard store + progress marker every N batches during
    #: ingest (0 = only at the end, the reference's behavior).
    checkpoint_every_batches: int = 16
    #: Measure a sequential NumPy scan of the same search inside the driver
    #: and feed it to the benchmark report's speedup hook (reference:
    #: src/mpi_helpers/benchmark.rs:361-416 prints "speedup Nx" only when
    #: sequential times are supplied). Off by default: it pulls the store
    #: to the host, which is costly for multi-GB stores.
    measure_serial_baseline: bool = False
    #: Let a merge rebuild global.npy even when an incremental
    #: ``update()`` left it AHEAD of the per-shard stores (the appended rows
    #: live in no shard and are discarded by the rebuild — only safe after a
    #: full re-ingest of every shard). Default False: merge fails loudly.
    force_merge: bool = False
    #: Let the merge publish a global store with missing/unreadable shards
    #: (recorded in a ``global.npy.partial`` marker). Default False:
    #: a crashed ingest host fails the merge instead of silently shipping
    #: an incomplete store.
    allow_partial_merge: bool = False

    @staticmethod
    def from_env() -> "PipelineConfig":
        """Honour the reference's env knobs (src/main.rs:42-45) on top of
        defaults."""
        skip = os.environ.get("SKIP_PROCESS", "").lower() in ("1", "true", "yes")
        return PipelineConfig(skip_process=skip)

    def replace(self, **kwargs) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)

"""better_search_rag_rust_tpu — exact top-k retrieval framework for RAG.

A ground-up JAX/XLA rebuild of the capabilities of the Rust+MPI reference
``nichmorgan/better-search-rag-rust`` (see SURVEY.md):

1. Corpus ingestion           -> :mod:`.corpus`        (reference: src/source.rs)
2. Batched embedding          -> :mod:`.models`        (reference: src/llm/)
3. Persistent vector store    -> :mod:`.store`         (reference: src/vectorstore/)
4. Parallel exact top-k       -> :mod:`.ops`,
                                 :mod:`.parallel`      (reference: src/mpi_helpers/)
5. Accuracy + perf harness    -> :mod:`.metrics`,
                                 :mod:`.bench`         (reference: src/metrics.rs,
                                                        src/mpi_helpers/benchmark.rs)

The distribution model is device-mesh first: a ``jax.sharding.Mesh`` over a device axis
replaces MPI ranks, block sharding of the embedding store replaces
``interval_by_rank``, and ``shard_map`` + ``all_gather`` + ``lax.top_k`` replace
the reference's hand-rolled gather-v over p2p sends.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CorpusConfig,
    EncoderConfig,
    MeshConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)

"""Encoder service — the framework's ``LlmService`` equivalent.

The reference defines a two-method backend trait (constructor + batch embed,
reference: src/llm/mod.rs:5-13) and one implementation (ONNX HfService,
src/llm/hf.rs). Here the service composes a tokenizer with a jitted forward
and enforces the reference's embedding contract (SURVEY.md §3.5):

* empty input -> ``[0, dim]`` (src/llm/hf.rs:51-53);
* any empty string in the batch -> error "Invalid inputs: has empty values"
  (src/llm/hf.rs:54-56);
* fixed 512-token right-padding, pad id 0 (src/llm/hf.rs:62-79);
* one f32 embedding row per input text (src/llm/hf.rs:118-123).

Addition: inputs are re-batched to a *fixed* ``batch_size`` (last batch
zero-padded, rows sliced off after the forward) so XLA compiles the forward
exactly once — the reference instead pays a new ONNX shape per ragged batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, Sequence

import numpy as np

from ..config import EncoderConfig
from ..utils.logging import host_log
from .hash_encoder import HashEncoder
from .nomic import NomicBertConfig, NomicEncoder, load_hf_checkpoint
from .tokenizer import load_tokenizer


class TokenEncoder(Protocol):
    def encode_tokens(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> np.ndarray: ...


class TokenBatch(NamedTuple):
    """Tokenized text batch, ready for the device forward.

    ``groups`` maps token rows to document indices when ``long_doc="mean"``
    windowing expanded documents into multiple rows; ``None`` otherwise.
    """

    ids: np.ndarray
    mask: np.ndarray
    groups: Optional[np.ndarray]
    n_docs: int


class PendingEmbeddings(NamedTuple):
    """In-flight device forward: collect with
    :meth:`EncoderService.collect`. ``buffers`` holds one async device
    array (or eager host array) per fixed-size sub-batch."""

    buffers: list
    tb: TokenBatch
    n_rows: int


class EncoderService:
    """Batch text embedding with fixed-shape device batches
    (≙ trait ``LlmService``, reference: src/llm/mod.rs:5-13)."""

    def __init__(
        self,
        tokenizer,
        encoder: TokenEncoder,
        dim: int,
        batch_size: int = 32,
        long_doc: str = "truncate",
    ):
        self.tokenizer = tokenizer
        self.encoder = encoder
        self.dim = dim
        self.batch_size = batch_size
        self.long_doc = long_doc
        #: Human-readable backend label for reports/benchmarks
        #: ("hash", "nomic-random-init", "nomic-checkpoint", ...).
        self.backend_label = type(encoder).__name__
        #: Numerics fingerprint of the embedding computation (backend,
        #: resolved attention impl, compute dtype, ...). Recorded into the
        #: store's ``encoder.json`` at ingest so query-time numerics drift
        #: (e.g. an "auto" attention default changing) is visible instead of
        #: silent — embeddings differ at bf16-noise level across impls.
        self.numerics: dict = {}

    def tokenize(self, texts: Sequence[str]) -> TokenBatch:
        """Stage 1 (pure host work, thread-safe): texts -> token rows.

        Split out from :meth:`get_embeddings` so ingest can run it on a
        background thread, hiding tokenization (~0.5 ms/doc in pure Python)
        under the previous batch's device forward. Raises on empty strings
        (contract: "Invalid inputs: has empty values", src/llm/hf.rs:54-56).
        """
        n = len(texts)
        if n == 0:
            empty = np.zeros((0, 0), dtype=np.int32)
            return TokenBatch(empty, empty, None, 0)
        if self.long_doc == "mean" and hasattr(
            self.tokenizer, "encode_batch_windows"
        ):
            ids, mask, groups = self.tokenizer.encode_batch_windows(texts)
            return TokenBatch(ids, mask, groups, n)
        ids, mask = self.tokenizer.encode_batch(texts)  # raises on empty text
        return TokenBatch(ids, mask, None, n)

    def dispatch(
        self, tb: TokenBatch, host_copy: bool = True
    ) -> PendingEmbeddings:
        """Stage 2: launch the device forward for every fixed-``batch_size``
        sub-batch WITHOUT waiting (zero-mask padding rows for the ragged
        tail). Returns immediately with async device buffers; the caller may
        dispatch the next batch (or do host work) before :meth:`collect`.

        ``host_copy=False`` skips starting the device->host copies — for
        consumers that keep the embeddings on device (the serve fast
        path), where a host copy would be pure wasted transfer."""
        n = tb.ids.shape[0]
        if n == 0:
            return PendingEmbeddings([], tb, 0)
        ids, mask = tb.ids, tb.mask
        bs = self.batch_size
        padded_n = -(-n // bs) * bs
        if padded_n != n:
            pad_rows = padded_n - n
            ids = np.concatenate(
                [ids, np.zeros((pad_rows, ids.shape[1]), dtype=ids.dtype)]
            )
            # Padding rows get an all-zero mask; mean-pool guards divide-by-0.
            mask = np.concatenate(
                [mask, np.zeros((pad_rows, mask.shape[1]), dtype=mask.dtype)]
            )
        dev_fwd = getattr(self.encoder, "encode_tokens_device", None)
        if dev_fwd is not None:
            buffers = [
                dev_fwd(ids[s: s + bs], mask[s: s + bs])
                for s in range(0, padded_n, bs)
            ]
            # Start the device->host copy NOW: it fires as soon as the
            # forward finishes, so by collect time — one pipelined batch
            # later — the bytes are already in flight. Same trick as
            # SearchEngine.search_async: the synchronous per-batch readback
            # otherwise serializes with the next dispatch.
            if host_copy:
                for buf in buffers:
                    copy = getattr(buf, "copy_to_host_async", None)
                    if copy is not None:
                        copy()
        else:
            buffers = [
                self.encoder.encode_tokens(
                    ids[s: s + bs], mask[s: s + bs]
                )
                for s in range(0, padded_n, bs)
            ]
        return PendingEmbeddings(buffers, tb, n)

    def collect(self, pending: PendingEmbeddings) -> np.ndarray:
        """Stage 3: pull the forward's results to host and reduce windows.
        ``-> [n_docs, dim]`` float32."""
        tb = pending.tb
        if pending.n_rows == 0:
            return np.zeros((tb.n_docs, self.dim), dtype=np.float32)
        import jax

        bs = self.batch_size
        out = np.empty((len(pending.buffers) * bs, self.dim), dtype=np.float32)
        for i, buf in enumerate(pending.buffers):
            out[i * bs: (i + 1) * bs] = np.asarray(
                jax.device_get(buf), dtype=np.float32
            )
        return self._reduce_rows(tb, out[: pending.n_rows])

    def collect_many(
        self, pendings: Sequence[PendingEmbeddings]
    ) -> list:
        """Batched stage 3: ONE packed device->host readback for a window
        of in-flight dispatches (device-side concatenate + a single
        ``device_get``), amortizing the fixed per-readback cost across the
        window. Values are identical to
        ``[collect(p) for p in pendings]`` (same buffers, same reduce);
        only the transfer shape changes. Falls back to per-pending
        :meth:`collect` when the buffers are not all device arrays."""
        import jax

        bufs = [b for p in pendings for b in p.buffers]
        if len(bufs) <= 1 or not all(isinstance(b, jax.Array) for b in bufs):
            return [self.collect(p) for p in pendings]
        import jax.numpy as jnp

        packed = np.asarray(
            jax.device_get(jnp.concatenate(bufs, axis=0)), dtype=np.float32
        )
        bs = self.batch_size
        out, off = [], 0
        for p in pendings:
            span = len(p.buffers) * bs
            rows = packed[off: off + p.n_rows]
            off += span
            out.append(
                self._reduce_rows(p.tb, rows)
                if p.n_rows
                else np.zeros((p.tb.n_docs, self.dim), dtype=np.float32)
            )
        return out

    def _reduce_rows(self, tb: TokenBatch, rows: np.ndarray) -> np.ndarray:
        if tb.groups is None:
            return rows
        # long_doc="mean": mean-pool each document's windows, re-normalize.
        agg = np.zeros((tb.n_docs, self.dim), dtype=np.float32)
        np.add.at(agg, tb.groups, rows)
        counts = np.bincount(tb.groups, minlength=tb.n_docs).reshape(-1, 1)
        agg /= np.maximum(counts, 1)
        norms = np.linalg.norm(agg, axis=1, keepdims=True)
        return agg / np.where(norms == 0.0, 1.0, norms)

    def get_embeddings_device(self, texts: Sequence[str]):
        """Device-resident embeddings: ``[len(texts), dim]`` f32
        ``jax.Array``, or ``None`` when this backend/mode cannot keep
        results on device (no ``encode_tokens_device``, window pooling,
        empty input) — callers fall back to :meth:`get_embeddings`.

        This is the serve fast path: embeddings hand straight to
        ``SearchEngine.search_async`` without the synchronous device->host
        readback of :meth:`collect` OR the query re-upload — per text
        request, two host<->device round trips fewer. Raises the same
        empty-input contract errors as :meth:`get_embeddings` (both go
        through :meth:`tokenize`)."""
        if self.long_doc == "mean" and hasattr(
            self.tokenizer, "encode_batch_windows"
        ):
            return None  # window pooling is a host-side reduce
        if getattr(self.encoder, "encode_tokens_device", None) is None:
            return None
        tb = self.tokenize(texts)
        if tb.n_docs == 0:
            return None
        pending = self.dispatch(tb, host_copy=False)
        import jax
        import jax.numpy as jnp

        bufs = pending.buffers
        if not bufs or not all(isinstance(b, jax.Array) for b in bufs):
            return None
        cat = bufs[0] if len(bufs) == 1 else jnp.concatenate(bufs, axis=0)
        return cat[: pending.n_rows].astype(jnp.float32)

    def get_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        """``texts -> [len(texts), dim]`` float32
        (reference: src/llm/hf.rs:50-124).

        ``long_doc="truncate"``: text beyond ``max_tokens`` is dropped (the
        reference's semantics). ``long_doc="mean"``: the full token stream is
        windowed, every window encoded, windows mean-pooled per document and
        re-normalized — long files contribute all of their content instead
        of their first 512 tokens.

        Composition of the three pipeline stages; ingest calls the stages
        directly so batch ``i+1``'s tokenize and batch ``i``'s forward can
        overlap batch ``i-1``'s collect+append.
        """
        return self.collect(self.dispatch(self.tokenize(texts)))


def create_encoder(
    cfg: Optional[EncoderConfig] = None, mesh=None
) -> EncoderService:
    """Backend selection (``cfg.backend``):

    * ``"nomic"`` — NomicBERT; loads the local HF checkpoint when
      ``cfg.checkpoint_dir`` is set, otherwise random-init (shape-correct).
    * ``"hash"``  — deterministic hermetic encoder.
    * ``"auto"``  — nomic when a checkpoint dir is configured and exists,
      else hash (artifact-gated, reference: src/llm/hf.rs:138-144).

    ``mesh``: optional multi-device mesh for single-process data-parallel
    nomic encoding (batches shard over the first axis; ``cfg.batch_size``
    must divide by its size). Ignored by the host-side hash backend.
    """
    cfg = cfg or EncoderConfig()
    backend = cfg.backend
    if backend == "auto":
        import os

        backend = (
            "nomic"
            if cfg.checkpoint_dir and os.path.isdir(cfg.checkpoint_dir)
            else "hash"
        )

    if backend == "hash":
        enc = HashEncoder(
            dim=cfg.matryoshka_dim or cfg.dim,
            max_tokens=cfg.max_tokens,
            vocab_size=cfg.vocab_size,
            dtype=cfg.dtype,
        )
        svc = EncoderService(
            enc.tokenizer, enc, enc.dim, batch_size=cfg.batch_size,
            long_doc=cfg.long_doc,
        )
        svc.backend_label = "hash"
        svc.numerics = {
            "backend": "hash",
            "dtype": str(cfg.dtype),
            "dim": enc.dim,
            "max_tokens": cfg.max_tokens,
            "long_doc": cfg.long_doc,
        }
        return svc

    if backend == "nomic":
        if mesh is not None and mesh.size > 1 and cfg.batch_size % mesh.size:
            raise ValueError(
                f"batch_size {cfg.batch_size} does not divide over the "
                f"{mesh.size}-device mesh"
            )
        model_cfg = NomicBertConfig.from_encoder_config(cfg)
        params = None
        if cfg.checkpoint_dir:
            try:
                model_cfg, params = load_hf_checkpoint(
                    cfg.checkpoint_dir, model_cfg
                )
                host_log(f"loaded nomic checkpoint from {cfg.checkpoint_dir}")
            except FileNotFoundError as exc:
                host_log(f"checkpoint missing ({exc}); using random init")
        enc = NomicEncoder(
            model_cfg, params=params, matryoshka_dim=cfg.matryoshka_dim,
            mesh=mesh,
        )
        tokenizer = load_tokenizer(
            cfg.checkpoint_dir, cfg.max_tokens, cfg.vocab_size
        )
        svc = EncoderService(
            tokenizer, enc, enc.dim, batch_size=cfg.batch_size,
            long_doc=cfg.long_doc,
        )
        svc.backend_label = (
            "nomic-checkpoint" if params is not None else "nomic-random-init"
        )
        from .nomic import resolve_attention_impl

        svc.numerics = {
            "backend": svc.backend_label,
            "model": cfg.name,
            # Record the impl the forward will ACTUALLY run on this
            # platform, so the serve-time mismatch warning is keyed on
            # real numerics.
            "attention_impl": resolve_attention_impl(
                model_cfg.attention_impl, model_cfg.dtype
            ),
            "dtype": str(cfg.dtype),
            "dim": enc.dim,
            "max_tokens": cfg.max_tokens,
            "long_doc": cfg.long_doc,
            "matryoshka_dim": cfg.matryoshka_dim,
        }
        if enc.mesh is not None:
            # Mesh-DP encoding shifts embeddings at bf16-noise level vs the
            # single-device forward (per-shard XLA compilation): record it
            # so a device-count change between ingest and serve warns.
            svc.numerics["dp_devices"] = int(enc.mesh.size)
        return svc

    raise ValueError(f"unknown encoder backend {backend!r}")

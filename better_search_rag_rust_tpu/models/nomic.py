"""NomicBERT (``nomic-embed-text-v1.5``) as plain JAX functions.

This replaces the reference's ONNX-Runtime encoder (reference:
src/llm/hf.rs:8-125 — session load at :8-19, CUDA EP at :34, batch forward at
:50-124). Instead of shipping a frozen ONNX graph, the architecture is
implemented directly so XLA can fuse, shard and bf16 it:

* BERT-base backbone: 12 layers, 768 hidden, 12 heads, post-LayerNorm
  residuals (eps 1e-12), vocab 30528, type vocab 2;
* **rotary position embeddings** (base 1000, full fraction, NeoX-style
  rotate-halves) instead of learned absolute positions;
* **SwiGLU MLP** (fc11 ⊙ silu(fc12) → fc2, 3072 inner);
* no biases on the QKV and MLP input projections (the checkpoint has none);
* mean pooling over the attention mask + L2 normalization, with optional
  Matryoshka truncation (v1.5 is Matryoshka-trained: layer-norm, slice to
  ``matryoshka_dim``, re-normalize).

The parameters are a nested dict (``word_embeddings``, ``emb_norm``,
``layer_{i}/attn/Wqkv``, ...; Dense layers hold ``kernel [in, out]`` and
``bias``, norms ``scale`` and ``bias``). :func:`init_params` builds one from
a seed; :func:`load_hf_checkpoint` fills it from a local HF export. With no
checkpoint the model still runs (random init) so shape/sharding tests and
benchmarks are hermetic — the same artifact-gated discipline as the
reference's model tests (src/llm/hf.rs:138-144).

The forward is shape-static: ``[B, max_tokens]`` int32 ids + mask, exactly the
reference's fixed right-padding to 512 (src/llm/hf.rs:62-79), which is also
what the XLA compile cache wants.
"""

from __future__ import annotations

import itertools
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EncoderConfig

#: Values of ``NomicBertConfig.attention_impl``.
ATTENTION_IMPLS = ("auto", "cudnn", "xla", "xla_bf16")


@dataclass(frozen=True)
class NomicBertConfig:
    """Architecture hyperparameters (defaults = nomic-embed-text-v1.5)."""

    vocab_size: int = 30528
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_tokens: int = 512
    type_vocab_size: int = 2
    rotary_base: float = 1000.0
    layer_norm_eps: float = 1e-12
    activation: str = "swiglu"  # "swiglu" | "gelu"
    qkv_bias: bool = False
    mlp_bias: bool = False
    dtype: Any = jnp.bfloat16
    #: One of :data:`ATTENTION_IMPLS`; see :func:`resolve_attention_impl`.
    attention_impl: str = "auto"
    #: Megatron-style sequence parallelism: when set to (data_axis,
    #: model_axis) mesh names, the residual stream between blocks is
    #: sharded [batch@data, seq@model, hidden] — layernorms and elementwise
    #: work split over the TP axis, XLA inserting the all-gather at each
    #: block's matmul boundary (and the reduce-scatter back).
    sp_mesh_axes: Optional[Tuple[str, str]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_encoder_config(cfg: EncoderConfig) -> "NomicBertConfig":
        if cfg.dim % cfg.num_heads:
            raise ValueError(
                f"hidden dim {cfg.dim} is not divisible by num_heads "
                f"{cfg.num_heads}; pass a matching --dim/num_heads pair"
            )
        return NomicBertConfig(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.dim,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            mlp_dim=cfg.mlp_dim,
            max_tokens=cfg.max_tokens,
            type_vocab_size=cfg.type_vocab_size,
            rotary_base=cfg.rotary_base,
            layer_norm_eps=cfg.layer_norm_eps,
            activation=cfg.activation,
            dtype=jnp.dtype(cfg.dtype),
            attention_impl=cfg.attention_impl,
        )


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rotary_tables(
    seq_len: int, head_dim: int, base: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Static ``(cos [S, D/2], sin [S, D/2])`` tables — computed once on host,
    closed over by the jitted forward (static shapes, no recompute)."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # [S, D/2]
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rotary(
    x: jax.Array, cos: jax.Array, sin: jax.Array
) -> jax.Array:
    """NeoX-style (rotate-halves, non-interleaved) rotary on ``[B, S, H, D]``.

    The checkpoint was trained with flash-attn's ``RotaryEmbedding``
    (interleaved=False), which splits the head dim into two halves.
    """
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    # cos/sin: [S, D/2] -> broadcast over batch and heads.
    cos = cos[None, :, None, :].astype(x.dtype)
    sin = sin[None, :, None, :].astype(x.dtype)
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
    )


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def resolve_attention_impl(
    impl: str, dtype=jnp.bfloat16, platform: Optional[str] = None
) -> str:
    """The attention implementation that runs for ``impl``.

    ``"auto"`` is chosen by platform, never by a fallback on failure:

    * ``gpu``: ``"cudnn"`` — cuDNN's fused attention through
      :func:`jax.nn.dot_product_attention`, which keeps the ``[S, S]``
      logits on chip and has its own backward. cuDNN takes only 16-bit
      operands, so float32 models resolve to ``"xla"``.
    * ``cpu``: ``"xla"`` — the f32-logit chain (the parity reference).

    Any other platform, or an unknown ``impl``, raises."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {impl!r}; expected one of "
            f"{ATTENTION_IMPLS}"
        )
    if impl != "auto":
        return impl
    platform = platform or jax.default_backend()
    if platform == "gpu":
        sixteen_bit = jnp.dtype(dtype) in (jnp.bfloat16, jnp.float16)
        return "cudnn" if sixteen_bit else "xla"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no attention implementation for platform {platform!r}")


def seq_lengths(attention_mask: jax.Array) -> jax.Array:
    """``[B, S]`` right-padded mask -> ``[B]`` int32 valid lengths, at least
    1: an all-padding row (a batch-fill row) attends to its first token,
    so every row stays finite."""
    n = jnp.sum(attention_mask.astype(jnp.int32), axis=1)
    return jnp.maximum(n, 1).astype(jnp.int32)


def padded_attention(
    q: jax.Array, k: jax.Array, v: jax.Array, lengths: jax.Array,
    implementation: str = "cudnn",
) -> jax.Array:
    """``[B, S, H, D]`` attention over right-padded sequences of
    ``lengths`` through :func:`jax.nn.dot_product_attention` — key padding
    and padded query rows both ride the sequence lengths, so cuDNN skips
    them. Outputs at padded query rows are unspecified (mean pooling drops
    them)."""
    return jax.nn.dot_product_attention(
        q, k, v,
        query_seq_lengths=lengths,
        key_value_seq_lengths=lengths,
        implementation=implementation,
    )


def xla_attention(
    q: jax.Array, k: jax.Array, v: jax.Array, mask_bias: jax.Array,
    bf16_logits: bool = False,
) -> jax.Array:
    """The einsum chain over ``[B, S, H, D]`` with an additive key-padding
    bias ``[B, 1, 1, S]``: f32 logits (the parity reference), or bf16
    logits with an f32 softmax (``bf16_logits``)."""
    hd = q.shape[-1]
    if bf16_logits:
        logits = jnp.einsum(
            "bshd,bthd->bhst", q, k, preferred_element_type=jnp.bfloat16
        ) * jnp.bfloat16(1.0 / math.sqrt(hd))
        logits = (logits + mask_bias.astype(jnp.bfloat16)).astype(jnp.float32)
    else:
        logits = jnp.einsum(
            "bshd,bthd->bhst", q, k, preferred_element_type=jnp.float32
        ) / math.sqrt(hd)
        logits = logits + mask_bias
    probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum(
        "bhst,bthd->bshd", probs, v, preferred_element_type=jnp.float32
    ).astype(q.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(config: NomicBertConfig, seed: int = 0) -> Dict:
    """Random float32 parameters from ``seed``: LeCun-normal Dense kernels,
    zero biases, unit-variance-over-fan-in embeddings, identity norms."""
    d, m = config.hidden_size, config.mlp_dim
    root = jax.random.PRNGKey(seed)
    keys = (jax.random.fold_in(root, i) for i in itertools.count())
    lecun = jax.nn.initializers.lecun_normal()
    embed = jax.nn.initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0
    )

    def dense(n_in, n_out, bias):
        p = {"kernel": lecun(next(keys), (n_in, n_out), jnp.float32)}
        if bias:
            p["bias"] = jnp.zeros((n_out,), jnp.float32)
        return p

    def norm():
        return {"scale": jnp.ones((d,), jnp.float32),
                "bias": jnp.zeros((d,), jnp.float32)}

    params: Dict[str, Any] = {
        "word_embeddings": {"embedding": embed(
            next(keys), (config.vocab_size, d), jnp.float32)},
        "token_type_embeddings": {"embedding": embed(
            next(keys), (config.type_vocab_size, d), jnp.float32)},
        "emb_norm": norm(),
    }
    for i in range(config.num_layers):
        if config.activation == "swiglu":
            mlp = {"fc11": dense(d, m, config.mlp_bias),
                   "fc12": dense(d, m, config.mlp_bias)}
        else:
            mlp = {"fc1": dense(d, m, True)}
        mlp["fc2"] = dense(m, d, True)
        params[f"layer_{i}"] = {
            "attn": {"Wqkv": dense(d, 3 * d, config.qkv_bias),
                     "out_proj": dense(d, d, True)},
            "mlp": mlp,
            "norm1": norm(),
            "norm2": norm(),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _dense(p: Dict, x: jax.Array, dtype) -> jax.Array:
    """``x @ kernel (+ bias)`` with operands cast to the compute dtype."""
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def _layer_norm(p: Dict, x: jax.Array, eps: float) -> jax.Array:
    """LayerNorm in float32 (variance as E[x^2] - E[x]^2, clamped at 0)."""
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    mean2 = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    var = jnp.maximum(0.0, mean2 - jnp.square(mean))
    return (x - mean) * (jax.lax.rsqrt(var + eps) * p["scale"]) + p["bias"]


def _sp_constrain(x: jax.Array, cfg: NomicBertConfig, gathered: bool):
    """Sequence-parallel sharding constraint on ``[B, S, D]`` activations:
    ``gathered=False`` shards the sequence dim over the TP axis (norm /
    residual regions), ``gathered=True`` replicates it (matmul regions)."""
    if cfg.sp_mesh_axes is None:
        return x
    from jax.sharding import PartitionSpec as P

    data_ax, model_ax = cfg.sp_mesh_axes
    spec = P(data_ax, None, None) if gathered else P(data_ax, model_ax, None)
    return jax.lax.with_sharding_constraint(x, spec)


def _heads_constrain(t: jax.Array, cfg: NomicBertConfig) -> jax.Array:
    """Under sequence parallelism, pin ``[B, S, H, D]`` attention operands
    to batch@data, heads@model and the WHOLE sequence per device: the
    Megatron attention layout, and the only one cuDNN's partitioner takes
    (it refuses a sharded sequence dim, which XLA would otherwise
    propagate in from the sequence-sharded residual stream)."""
    if cfg.sp_mesh_axes is None:
        return t
    from jax.sharding import PartitionSpec as P

    data_ax, model_ax = cfg.sp_mesh_axes
    return jax.lax.with_sharding_constraint(t, P(data_ax, None, model_ax, None))


def _attention_block(p, x, mask_bias, lengths, cos, sin, cfg, impl):
    b, s, d = x.shape
    qkv = _dense(p["Wqkv"], x, cfg.dtype).reshape(
        b, s, 3, cfg.num_heads, cfg.head_dim
    )
    q = _heads_constrain(apply_rotary(qkv[:, :, 0], cos, sin), cfg)
    k = _heads_constrain(apply_rotary(qkv[:, :, 1], cos, sin), cfg)
    v = _heads_constrain(qkv[:, :, 2], cfg)
    if impl == "cudnn":
        ctx = padded_attention(q, k, v, lengths, implementation="cudnn")
    else:
        ctx = xla_attention(q, k, v, mask_bias,
                            bf16_logits=(impl == "xla_bf16"))
    ctx = _heads_constrain(ctx, cfg)
    return _dense(p["out_proj"], ctx.reshape(b, s, d), cfg.dtype)


def _mlp_block(p, x, cfg):
    if cfg.activation == "swiglu":
        y = _dense(p["fc11"], x, cfg.dtype)
        y = y * jax.nn.silu(_dense(p["fc12"], x, cfg.dtype))
    else:
        y = jax.nn.gelu(_dense(p["fc1"], x, cfg.dtype), approximate=False)
    return _dense(p["fc2"], y, cfg.dtype)


def bert_forward(
    params: Dict, input_ids: jax.Array, attention_mask: jax.Array,
    config: NomicBertConfig,
) -> jax.Array:
    """Token ids + right-padded mask ``[B, S]`` -> final hidden states
    ``[B, S, D]``. Post-LN blocks: x = LN1(x + attn(x)); x = LN2(x + mlp(x))."""
    cfg = config
    impl = resolve_attention_impl(cfg.attention_impl, cfg.dtype)
    cos_np, sin_np = rotary_tables(
        input_ids.shape[1], cfg.head_dim, cfg.rotary_base
    )
    cos, sin = jnp.asarray(cos_np), jnp.asarray(sin_np)

    tok = jnp.take(
        params["word_embeddings"]["embedding"].astype(cfg.dtype), input_ids,
        axis=0,
    )
    # All real tokens are type 0 for retrieval encoding; keep the table so
    # checkpoint weights load and the op stays (embed row 0 broadcast).
    typ = jnp.take(
        params["token_type_embeddings"]["embedding"].astype(cfg.dtype),
        jnp.zeros_like(input_ids), axis=0,
    )
    x = _layer_norm(
        params["emb_norm"], (tok + typ).astype(jnp.float32),
        cfg.layer_norm_eps,
    ).astype(cfg.dtype)

    # Additive key-padding bias (XLA paths) / valid lengths (cuDNN).
    neg = jnp.asarray(-1e9, dtype=jnp.float32)
    mask_bias = jnp.where(attention_mask[:, None, None, :] > 0, 0.0, neg)
    lengths = seq_lengths(attention_mask)

    for i in range(cfg.num_layers):
        p = params[f"layer_{i}"]
        x = _sp_constrain(x, cfg, gathered=True)
        attn_out = _attention_block(
            p["attn"], x, mask_bias, lengths, cos, sin, cfg, impl
        )
        x = _layer_norm(
            p["norm1"],
            _sp_constrain((x + attn_out).astype(jnp.float32), cfg,
                          gathered=False),
            cfg.layer_norm_eps,
        ).astype(cfg.dtype)
        x = _sp_constrain(x, cfg, gathered=True)
        mlp_out = _mlp_block(p["mlp"], x, cfg)
        x = _layer_norm(
            p["norm2"],
            _sp_constrain((x + mlp_out).astype(jnp.float32), cfg,
                          gathered=False),
            cfg.layer_norm_eps,
        ).astype(cfg.dtype)
    return x


def mean_pool(hidden: jax.Array, attention_mask: jax.Array) -> jax.Array:
    """Masked mean over the sequence axis, in f32
    (nomic's ``mean_pooling``). ``[B, S, D] -> [B, D]``."""
    m = attention_mask.astype(jnp.float32)[:, :, None]
    summed = jnp.sum(hidden.astype(jnp.float32) * m, axis=1)
    denom = jnp.maximum(jnp.sum(m, axis=1), 1.0)
    return summed / denom


def finalize_embeddings(
    pooled: jax.Array, matryoshka_dim: Optional[int] = None
) -> jax.Array:
    """v1.5 post-processing: layer-norm, optional Matryoshka slice, then
    L2-normalize — all in f32."""
    x = pooled.astype(jnp.float32)
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    x = (x - mu) * jax.lax.rsqrt(var + 1e-12)
    if matryoshka_dim is not None and matryoshka_dim < x.shape[-1]:
        x = x[:, :matryoshka_dim]
    norms = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.where(norms == 0.0, 1.0, norms)


def embed(
    params: Dict, input_ids: jax.Array, attention_mask: jax.Array,
    config: NomicBertConfig, matryoshka_dim: Optional[int] = None,
) -> jax.Array:
    """``[B, S]`` ids + mask -> ``[B, dim]`` f32 unit embeddings."""
    hidden = bert_forward(params, input_ids, attention_mask, config)
    return finalize_embeddings(mean_pool(hidden, attention_mask),
                               matryoshka_dim)


class NomicEncoder:
    """Jitted text-encoder head around :func:`embed`.

    Produces one embedding row per input text — the reference's contract of
    "[B, 768] f32, one row per file, truncated at 512 tokens"
    (src/llm/hf.rs:112-123)."""

    def __init__(
        self,
        config: NomicBertConfig,
        params: Optional[Dict] = None,
        matryoshka_dim: Optional[int] = None,
        seed: int = 0,
        mesh: Optional[jax.sharding.Mesh] = None,
    ):
        """``mesh``: optional device mesh for single-process data-parallel
        encoding — batches shard over the mesh's FIRST axis (every
        fixed-size sub-batch must divide by it), params replicate.
        None = default-device serving."""
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.config = config
        if params is None:
            params = init_params(config, seed)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            params = jax.device_put(params, NamedSharding(self.mesh, P()))
            self._batch_sharding = NamedSharding(
                self.mesh, P(self.mesh.axis_names[0], None)
            )
        self.params = params
        self.matryoshka_dim = matryoshka_dim
        self._fwd = jax.jit(
            lambda p, ids, mask: embed(p, ids, mask, config, matryoshka_dim)
        )

    @property
    def dim(self) -> int:
        return self.matryoshka_dim or self.config.hidden_size

    def encode_tokens_device(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> jax.Array:
        """``[B, S]`` int32 ids+mask -> ``[B, dim]`` f32 embeddings, left on
        device (the serving hot path: dispatches pipeline, and the search
        engine can consume the array without a host round-trip)."""
        if self.mesh is not None:
            # DP over the mesh: shard the HOST batch straight onto the mesh
            # (one upload per shard — jnp.asarray first would commit the
            # full array to device 0 and re-distribute).
            ids = jax.device_put(
                np.asarray(input_ids, dtype=np.int32), self._batch_sharding
            )
            mask = jax.device_put(
                np.asarray(attention_mask, dtype=np.int32),
                self._batch_sharding,
            )
            return self._fwd(self.params, ids, mask)
        return self._fwd(
            self.params,
            jnp.asarray(input_ids, dtype=jnp.int32),
            jnp.asarray(attention_mask, dtype=jnp.int32),
        )

    def encode_tokens(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> np.ndarray:
        """``[B, S]`` int32 ids+mask -> ``[B, dim]`` f32 embeddings."""
        out = self.encode_tokens_device(input_ids, attention_mask)
        return np.asarray(jax.device_get(out), dtype=np.float32)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

# The checkpoint stores fused GLU input projections as one tensor
# ``mlp.fc1.weight`` of shape [2*inner, hidden] in some exports and split
# fc11/fc12 in others; both are handled below.


def _to_f32(t) -> np.ndarray:
    arr = np.asarray(t)
    if arr.dtype == np.float16 or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr, dtype=np.float32)


def _load_raw_state(checkpoint_dir: Path) -> Dict[str, np.ndarray]:
    """Read every tensor from safetensors / torch .bin files in the dir."""
    state: Dict[str, np.ndarray] = {}
    st_files = sorted(checkpoint_dir.glob("*.safetensors"))
    if st_files:
        from safetensors import safe_open

        for f in st_files:
            # framework="np" cannot represent bf16; go through torch when
            # present, else numpy with manual cast.
            try:
                with safe_open(str(f), framework="pt") as reader:
                    for key in reader.keys():
                        state[key] = _to_f32(reader.get_tensor(key).float().numpy())
            except Exception:
                with safe_open(str(f), framework="np") as reader:
                    for key in reader.keys():
                        state[key] = _to_f32(reader.get_tensor(key))
        return state
    bin_files = sorted(checkpoint_dir.glob("*.bin"))
    if bin_files:
        import torch

        for f in bin_files:
            sd = torch.load(str(f), map_location="cpu", weights_only=True)
            for key, t in sd.items():
                state[key] = _to_f32(t.float().numpy())
        return state
    raise FileNotFoundError(
        f"no *.safetensors or *.bin weights under {checkpoint_dir}"
    )


def _strip_prefixes(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        for pre in ("model.", "bert.", "nomic_bert."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def convert_hf_params(
    state: Dict[str, np.ndarray], config: NomicBertConfig
) -> Dict:
    """Map HF ``nomic-bert`` tensor names onto the :func:`init_params` tree.

    HF layout (modeling_hf_nomic_bert):
      emb.word_embeddings / emb.token_type_embeddings / emb_ln
      encoder.layers.{i}.attn.Wqkv, .attn.out_proj,
      .norm1, .norm2, .mlp.fc11/.fc12 (or fused .fc1), .mlp.fc2
    Linear weights are [out, in] in torch -> transposed to [in, out].
    """
    state = _strip_prefixes(state)
    d = config.hidden_size

    def t(name):  # torch linear weight [out, in] -> kernel [in, out]
        return np.ascontiguousarray(state[name].T)

    def get(*names):
        for n in names:
            if n in state:
                return state[n]
        raise KeyError(f"none of {names} in checkpoint ({len(state)} tensors)")

    def get_t(*names):
        for n in names:
            if n in state:
                return t(n)
        raise KeyError(f"none of {names} in checkpoint")

    params: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": get(
                "embeddings.word_embeddings.weight", "emb.word_embeddings.weight"
            )
        },
        "token_type_embeddings": {
            "embedding": get(
                "embeddings.token_type_embeddings.weight",
                "emb.token_type_embeddings.weight",
            )
        },
        "emb_norm": {
            "scale": get("emb_ln.weight", "embeddings.LayerNorm.weight"),
            "bias": get("emb_ln.bias", "embeddings.LayerNorm.bias"),
        },
    }
    for i in range(config.num_layers):
        pre = f"encoder.layers.{i}"
        layer: Dict[str, Any] = {}
        attn: Dict[str, Any] = {"Wqkv": {"kernel": get_t(f"{pre}.attn.Wqkv.weight")}}
        if f"{pre}.attn.Wqkv.bias" in state:
            attn["Wqkv"]["bias"] = state[f"{pre}.attn.Wqkv.bias"]
        attn["out_proj"] = {
            "kernel": get_t(f"{pre}.attn.out_proj.weight"),
            "bias": state.get(
                f"{pre}.attn.out_proj.bias", np.zeros(d, np.float32)
            ),
        }
        layer["attn"] = attn
        mlp: Dict[str, Any] = {}
        if f"{pre}.mlp.fc11.weight" in state:
            mlp["fc11"] = {"kernel": get_t(f"{pre}.mlp.fc11.weight")}
            mlp["fc12"] = {"kernel": get_t(f"{pre}.mlp.fc12.weight")}
        elif config.activation == "swiglu":
            fused = state[f"{pre}.mlp.fc1.weight"]  # [2*inner, d]
            inner = fused.shape[0] // 2
            # flash-attn GatedMlp: fc1 output splits as (y, gate).
            mlp["fc11"] = {"kernel": np.ascontiguousarray(fused[:inner].T)}
            mlp["fc12"] = {"kernel": np.ascontiguousarray(fused[inner:].T)}
        else:
            mlp["fc1"] = {
                "kernel": get_t(f"{pre}.mlp.fc1.weight"),
                "bias": state.get(
                    f"{pre}.mlp.fc1.bias",
                    np.zeros(config.mlp_dim, np.float32),
                ),
            }
        mlp["fc2"] = {
            "kernel": get_t(f"{pre}.mlp.fc2.weight"),
            "bias": state.get(f"{pre}.mlp.fc2.bias", np.zeros(d, np.float32)),
        }
        layer["mlp"] = mlp
        layer["norm1"] = {
            "scale": state[f"{pre}.norm1.weight"],
            "bias": state[f"{pre}.norm1.bias"],
        }
        layer["norm2"] = {
            "scale": state[f"{pre}.norm2.weight"],
            "bias": state[f"{pre}.norm2.bias"],
        }
        params[f"layer_{i}"] = layer
    return jax.tree.map(jnp.asarray, params)


def load_hf_checkpoint(
    checkpoint_dir: str, config: Optional[NomicBertConfig] = None
) -> Tuple[NomicBertConfig, Dict]:
    """Load a local HF export of nomic-embed-text-v1.5 into (config, params).

    Reads ``config.json`` when present to pick up architecture overrides
    (n_layer, n_head, rotary base, ...)."""
    ckpt = Path(checkpoint_dir)
    if config is None:
        config = NomicBertConfig()
    cfg_file = ckpt / "config.json"
    if cfg_file.exists():
        hf = json.loads(cfg_file.read_text())
        config = NomicBertConfig(
            vocab_size=hf.get("vocab_size", config.vocab_size),
            hidden_size=hf.get("n_embd", hf.get("hidden_size", config.hidden_size)),
            num_layers=hf.get("n_layer", hf.get("num_hidden_layers", config.num_layers)),
            num_heads=hf.get("n_head", hf.get("num_attention_heads", config.num_heads)),
            mlp_dim=hf.get("n_inner", hf.get("intermediate_size", config.mlp_dim)),
            max_tokens=config.max_tokens,
            type_vocab_size=hf.get("type_vocab_size", config.type_vocab_size),
            rotary_base=hf.get("rotary_emb_base", config.rotary_base),
            layer_norm_eps=hf.get("layer_norm_epsilon", config.layer_norm_eps),
            activation="swiglu"
            if hf.get("activation_function", "swiglu") in ("swiglu", "silu")
            else "gelu",
            qkv_bias=hf.get("qkv_proj_bias", config.qkv_bias),
            mlp_bias=hf.get("mlp_fc1_bias", config.mlp_bias),
            dtype=config.dtype,
            attention_impl=config.attention_impl,
        )
    state = _load_raw_state(ckpt)
    return config, convert_hf_params(state, config)

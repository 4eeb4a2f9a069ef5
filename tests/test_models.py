"""Encoder layer tests.

Mirrors the reference's encoder suite (reference: src/llm/hf.rs:127-317):
dim=768 and non-degenerate values, batch rows differ, empty-string error,
empty batch -> [], determinism across calls — plus the tokenizer fixed-shape
contract and the JAX NomicBERT forward (random-init, shape/grad checks).
"""

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import EncoderConfig
from better_search_rag_rust_tpu.models import (
    EncoderService,
    HashEncoder,
    HashingTokenizer,
    NomicBertConfig,
    NomicEncoder,
    create_encoder,
)
from better_search_rag_rust_tpu.models.tokenizer import TokenizerError


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


def test_hashing_tokenizer_fixed_shape():
    tok = HashingTokenizer(vocab_size=1000, max_tokens=16)
    ids, mask = tok.encode_batch(["hello world", "a"])
    assert ids.shape == (2, 16) and mask.shape == (2, 16)
    assert ids.dtype == np.int32
    # CLS + 2 tokens + SEP
    assert mask[0].sum() == 4 and mask[1].sum() == 3
    # right-padded with PAD_ID=0 (reference: src/llm/hf.rs:70-71)
    assert (ids[0][mask[0] == 0] == 0).all()


def test_hashing_tokenizer_deterministic():
    tok = HashingTokenizer(vocab_size=5000, max_tokens=32)
    a, _ = tok.encode_batch(["def foo(): pass"])
    b, _ = tok.encode_batch(["def foo(): pass"])
    np.testing.assert_array_equal(a, b)


def test_hashing_tokenizer_truncates():
    tok = HashingTokenizer(vocab_size=1000, max_tokens=8)
    ids, mask = tok.encode_batch(["w " * 100])
    assert ids.shape == (1, 8)
    assert mask[0].sum() == 8


def test_tokenizer_rejects_empty_string():
    tok = HashingTokenizer()
    # reference: src/llm/hf.rs:54-56 "Invalid inputs: has empty values"
    with pytest.raises(TokenizerError, match="has empty values"):
        tok.encode_batch(["ok", ""])


def test_tokenizer_empty_batch():
    tok = HashingTokenizer(max_tokens=16)
    ids, mask = tok.encode_batch([])
    assert ids.shape == (0, 16)


# ---------------------------------------------------------------------------
# Hash encoder service (hermetic backend)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hash_service():
    return create_encoder(
        EncoderConfig(backend="hash", dim=64, vocab_size=2048, max_tokens=64,
                      batch_size=4)
    )


def test_embeddings_shape_and_values(hash_service):
    # reference: src/llm/hf.rs:170-202 — correct dim, non-degenerate values
    out = hash_service.get_embeddings(["public class Foo {}", "import jax"])
    assert out.shape == (2, 64)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.abs(out).sum() > 0
    # rows are L2-normalized
    np.testing.assert_allclose(
        np.linalg.norm(out, axis=1), 1.0, rtol=1e-4
    )


def test_embeddings_batch_rows_differ(hash_service):
    # reference: src/llm/hf.rs:204-239
    out = hash_service.get_embeddings(["alpha beta gamma", "delta epsilon"])
    assert not np.allclose(out[0], out[1])


def test_embeddings_empty_string_error(hash_service):
    # reference: src/llm/hf.rs:241-265
    with pytest.raises(TokenizerError, match="has empty values"):
        hash_service.get_embeddings(["fine", ""])


def test_embeddings_empty_batch(hash_service):
    # reference: src/llm/hf.rs:267-287
    out = hash_service.get_embeddings([])
    assert out.shape == (0, 64)


def test_embeddings_deterministic(hash_service):
    # reference: src/llm/hf.rs:289-316
    a = hash_service.get_embeddings(["static void main", "class B"])
    b = hash_service.get_embeddings(["static void main", "class B"])
    np.testing.assert_array_equal(a, b)


def test_ragged_batch_padding(hash_service):
    """Fixed-shape re-batching: 5 texts through batch_size=4 must equal the
    same texts encoded individually."""
    texts = [f"token{i} content here" for i in range(5)]
    full = hash_service.get_embeddings(texts)
    assert full.shape == (5, 64)
    for i, t in enumerate(texts):
        single = hash_service.get_embeddings([t])
        np.testing.assert_allclose(full[i], single[0], atol=1e-6)


def test_similar_texts_are_nearer(hash_service):
    a, b, c = hash_service.get_embeddings(
        [
            "public static void main string args",
            "public static void main string argv",
            "zzz qqq completely unrelated xxx yyy",
        ]
    )
    assert a @ b > a @ c


# ---------------------------------------------------------------------------
# NomicBERT forward (random init — shape, mask, determinism)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_nomic():
    cfg = NomicBertConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        mlp_dim=128, max_tokens=32,
    )
    return NomicEncoder(cfg, seed=0)


def test_nomic_forward_shape(tiny_nomic):
    ids = np.random.default_rng(0).integers(0, 512, size=(3, 32)).astype(np.int32)
    mask = np.ones((3, 32), dtype=np.int32)
    out = tiny_nomic.encode_tokens(ids, mask)
    assert out.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-3)


def test_nomic_mask_ignores_padding(tiny_nomic):
    """A padded row must encode identically regardless of pad-token ids."""
    rng = np.random.default_rng(1)
    ids_a = rng.integers(1, 512, size=(1, 32)).astype(np.int32)
    ids_b = ids_a.copy()
    mask = np.zeros((1, 32), dtype=np.int32)
    mask[0, :10] = 1
    ids_b[0, 10:] = 0  # different pad ids beyond the mask
    out_a = tiny_nomic.encode_tokens(ids_a, mask)
    out_b = tiny_nomic.encode_tokens(ids_b, mask)
    np.testing.assert_allclose(out_a, out_b, atol=2e-2)


def test_nomic_deterministic(tiny_nomic):
    ids = np.arange(32, dtype=np.int32).reshape(1, 32) % 512
    mask = np.ones((1, 32), dtype=np.int32)
    a = tiny_nomic.encode_tokens(ids, mask)
    b = tiny_nomic.encode_tokens(ids, mask)
    np.testing.assert_array_equal(a, b)


def test_nomic_mesh_dp_encode_matches_single_device(tiny_nomic):
    """Mesh-DP encoding (batch sharded over 8 devices) agrees with the
    single-device encoder to bf16 noise, and the service contract composes
    through create_encoder(mesh=...)."""
    from better_search_rag_rust_tpu.config import EncoderConfig
    from better_search_rag_rust_tpu.models.encoder import create_encoder
    from better_search_rag_rust_tpu.parallel import create_mesh

    mesh = create_mesh(shape=(8,), axis_names=("data",))
    enc_dp = NomicEncoder(tiny_nomic.config, params=tiny_nomic.params,
                          mesh=mesh)

    rng = np.random.default_rng(7)
    ids = rng.integers(1, 512, size=(16, 32)).astype(np.int32)
    mask = np.ones((16, 32), dtype=np.int32)
    ref = tiny_nomic.encode_tokens(ids, mask)
    out = enc_dp.encode_tokens(ids, mask)
    assert out.shape == ref.shape
    cos = (out * ref).sum(axis=1)
    assert (cos > 0.999).all(), f"mesh-DP embeddings drifted: {cos.min()}"

    # batch_size must divide the mesh
    with pytest.raises(ValueError, match="does not divide"):
        create_encoder(
            EncoderConfig(backend="nomic", batch_size=12), mesh=mesh
        )


def test_nomic_matryoshka_truncation():
    cfg = NomicBertConfig(
        vocab_size=128, hidden_size=64, num_layers=1, num_heads=4,
        mlp_dim=64, max_tokens=16,
    )
    enc = NomicEncoder(cfg, matryoshka_dim=32)
    ids = np.ones((2, 16), dtype=np.int32)
    mask = np.ones((2, 16), dtype=np.int32)
    out = enc.encode_tokens(ids, mask)
    assert out.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-3)


def test_rotary_tables_shape():
    from better_search_rag_rust_tpu.models.nomic import rotary_tables

    cos, sin = rotary_tables(16, 8, 1000.0)
    assert cos.shape == (16, 4) and sin.shape == (16, 4)
    np.testing.assert_allclose(cos[0], 1.0)
    np.testing.assert_allclose(sin[0], 0.0)


def test_hf_param_conversion_roundtrip():
    """convert_hf_params maps a synthetic torch-layout state dict onto the
    module tree and the forward runs with it."""
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import convert_hf_params

    cfg = NomicBertConfig(
        vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
        mlp_dim=32, max_tokens=8,
    )
    rng = np.random.default_rng(0)
    d, inner = cfg.hidden_size, cfg.mlp_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    state = {
        "embeddings.word_embeddings.weight": w(cfg.vocab_size, d),
        "embeddings.token_type_embeddings.weight": w(2, d),
        "emb_ln.weight": np.ones(d, np.float32),
        "emb_ln.bias": np.zeros(d, np.float32),
        "encoder.layers.0.attn.Wqkv.weight": w(3 * d, d),
        "encoder.layers.0.attn.out_proj.weight": w(d, d),
        "encoder.layers.0.attn.out_proj.bias": np.zeros(d, np.float32),
        "encoder.layers.0.norm1.weight": np.ones(d, np.float32),
        "encoder.layers.0.norm1.bias": np.zeros(d, np.float32),
        "encoder.layers.0.norm2.weight": np.ones(d, np.float32),
        "encoder.layers.0.norm2.bias": np.zeros(d, np.float32),
        # fused GLU fc1 layout: [2*inner, d]
        "encoder.layers.0.mlp.fc1.weight": w(2 * inner, d),
        "encoder.layers.0.mlp.fc2.weight": w(d, inner),
        "encoder.layers.0.mlp.fc2.bias": np.zeros(d, np.float32),
    }
    params = convert_hf_params(state, cfg)
    assert params["layer_0"]["mlp"]["fc11"]["kernel"].shape == (d, inner)
    enc = NomicEncoder(cfg, params=params)
    out = enc.encode_tokens(
        np.ones((1, 8), np.int32), np.ones((1, 8), np.int32)
    )
    assert out.shape == (1, 16) and np.isfinite(out).all()


def test_classic_bert_gelu_backbone():
    """The gelu activation path (classic BERT family, no gating) runs and
    produces normalized embeddings — the framework supports both the
    NomicBERT (swiglu/rotary) and vanilla BERT block structure."""
    cfg = NomicBertConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
        mlp_dim=64, max_tokens=16, activation="gelu",
    )
    enc = NomicEncoder(cfg, seed=7)
    ids = np.random.default_rng(8).integers(1, 128, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    out = enc.encode_tokens(ids, mask)
    assert out.shape == (3, 32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-3)


def test_cli_profile_dir(tmp_path, capsys):
    """--profile-dir captures a device trace around the run."""
    from better_search_rag_rust_tpu.cli import main

    root = tmp_path / "src"
    root.mkdir()
    for i in range(3):
        (root / f"A{i}.java").write_text(f"class A{i} {{}}")
    trace_dir = tmp_path / "trace"
    rc = main([
        "run", "--root", str(root), "--store-dir", str(tmp_path / "st"),
        "--encoder-backend", "hash", "--dim", "32", "--max-tokens", "16",
        "--top-k", "2", "--encode-batch-size", "2",
        "--profile-dir", str(trace_dir),
    ])
    assert rc == 0
    assert trace_dir.exists()


def test_long_doc_mean_windows():
    """long_doc="mean": a document longer than max_tokens contributes ALL of
    its content (the reference silently drops everything past the cap)."""
    svc_trunc = create_encoder(
        EncoderConfig(backend="hash", dim=48, vocab_size=2048, max_tokens=16,
                      batch_size=4, long_doc="truncate")
    )
    svc_mean = create_encoder(
        EncoderConfig(backend="hash", dim=48, vocab_size=2048, max_tokens=16,
                      batch_size=4, long_doc="mean")
    )
    # exactly one full window (max_tokens - 2 = 14 words)
    head = "alpha beta gamma delta eta theta iota kappa lam mu nu xi omi pi "
    tail = "omega psi chi phi " * 10              # lives past the cap
    long_doc = head + tail

    t = svc_trunc.get_embeddings([long_doc, head])
    m = svc_mean.get_embeddings([long_doc, head])
    # truncate mode cannot see the tail: long doc == its head
    np.testing.assert_allclose(t[0], t[1], atol=1e-6)
    # mean mode sees the tail: long doc != its head
    assert not np.allclose(m[0], m[1], atol=1e-3)
    # short docs are unaffected by the mode
    np.testing.assert_allclose(t[1], m[1], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(m, axis=1), 1.0, rtol=1e-4)


def test_window_tokenizer_group_ids():
    tok = HashingTokenizer(vocab_size=512, max_tokens=8)
    ids, mask, groups = tok.encode_batch_windows(
        ["one two three four five six seven eight nine", "short"]
    )
    # 9 words / 6-word windows -> 2 windows + 1 window
    assert ids.shape == (3, 8)
    np.testing.assert_array_equal(groups, [0, 0, 1])
    assert (mask.sum(axis=1) >= 3).all()
    empty = tok.encode_batch_windows([])
    assert empty[0].shape == (0, 8)


def test_xla_bf16_attention_parity():
    import dataclasses

    cfg = NomicBertConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        mlp_dim=128, max_tokens=64, attention_impl="xla",
    )
    enc = NomicEncoder(cfg, seed=11)
    enc_b = NomicEncoder(
        dataclasses.replace(cfg, attention_impl="xla_bf16"), params=enc.params
    )
    rng = np.random.default_rng(12)
    ids = rng.integers(1, 256, size=(3, 64)).astype(np.int32)
    mask = np.ones((3, 64), np.int32)
    mask[1, 40:] = 0
    a = enc.encode_tokens(ids, mask)
    b = enc_b.encode_tokens(ids, mask)
    cos = np.sum(a * b, axis=1)
    assert cos.min() > 0.999, cos


def test_staged_encode_matches_get_embeddings():
    """tokenize/dispatch/collect with several batches IN FLIGHT gives the
    same embeddings as the one-shot get_embeddings — the overlap the ingest
    pipeline relies on (collect lags dispatch by one batch)."""
    from better_search_rag_rust_tpu.models.encoder import create_encoder

    svc = create_encoder(EncoderConfig(backend="hash", dim=64, batch_size=4))
    batches = [
        [f"alpha doc {i} {j}" for j in range(5)] for i in range(3)
    ]
    want = [svc.get_embeddings(b) for b in batches]
    pendings = [svc.dispatch(svc.tokenize(b)) for b in batches]  # all queued
    for p, w in zip(pendings, want):
        np.testing.assert_array_equal(svc.collect(p), w)
    # empty batch contract survives the staged path
    empty = svc.collect(svc.dispatch(svc.tokenize([])))
    assert empty.shape == (0, 64)


def test_staged_encode_windows_mode():
    """The staged path reduces long_doc="mean" windows identically to the
    one-shot path."""
    from better_search_rag_rust_tpu.models.encoder import create_encoder

    svc = create_encoder(
        EncoderConfig(backend="hash", dim=32, batch_size=4,
                      max_tokens=16, long_doc="mean")
    )
    texts = ["word " * 100, "short", "medium " * 30]
    want = svc.get_embeddings(texts)
    got = svc.collect(svc.dispatch(svc.tokenize(texts)))
    np.testing.assert_array_equal(got, want)


def test_collect_many_matches_collect():
    """collect_many = one packed readback for a window of dispatches; the
    values must equal per-pending collect exactly (same buffers, same
    reduce), including empty batches and long-doc window pooling."""
    from better_search_rag_rust_tpu.models.encoder import create_encoder

    svc = create_encoder(EncoderConfig(backend="hash", dim=64, batch_size=4))
    batches = [
        [f"beta doc {i} {j}" for j in range(n)] for i, n in
        enumerate([5, 0, 3, 9])
    ]
    want = [svc.get_embeddings(b) for b in batches]
    pendings = [svc.dispatch(svc.tokenize(b)) for b in batches]
    got = svc.collect_many(pendings)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    # window-pooling mode rides the same packed path
    svc_w = create_encoder(
        EncoderConfig(backend="hash", dim=32, batch_size=4,
                      max_tokens=16, long_doc="mean")
    )
    wb = [["word " * 60, "short"], ["medium " * 20]]
    want_w = [svc_w.get_embeddings(b) for b in wb]
    got_w = svc_w.collect_many([svc_w.dispatch(svc_w.tokenize(b)) for b in wb])
    for g, w in zip(got_w, want_w):
        np.testing.assert_array_equal(g, w)

    # singleton window degrades to plain collect
    one = svc.collect_many([svc.dispatch(svc.tokenize(["solo text"]))])
    np.testing.assert_array_equal(one[0], svc.get_embeddings(["solo text"]))


# ---------------------------------------------------------------------------
# Attention: the cuDNN wrapper's plumbing, checked through JAX's XLA
# implementation of the same call (cuDNN itself runs only on the card)
# ---------------------------------------------------------------------------

#: Valid lengths per row at S=48: full, tail-padded, single token, mixed
#: per-row lengths, and an odd length.
_PAD_PATTERNS = {
    "full": [48, 48],
    "tail_padded": [30, 30],
    "single_token": [1, 48],
    "mixed": [48, 17],
    "odd": [37, 5],
}


def _qkv(seed, b=2, s=48, h=4, d=16):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((b, s, h, d)), jnp.float32)
            for _ in range(3)]


def _mask_for(lengths, s=48):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


@pytest.mark.parametrize("pattern", sorted(_PAD_PATTERNS))
def test_padded_attention_matches_f32_xla(pattern):
    """``padded_attention`` (the call the cuDNN path makes, here through
    JAX's own XLA implementation) equals the f32-logit einsum chain with an
    additive key-padding bias on every valid query row."""
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import (
        padded_attention, seq_lengths, xla_attention)

    q, k, v = _qkv(1)
    mask = _mask_for(_PAD_PATTERNS[pattern])
    bias = jnp.asarray(np.where(mask, 0.0, -1e9)[:, None, None, :],
                       jnp.float32)
    lengths = seq_lengths(jnp.asarray(mask))
    got = np.asarray(padded_attention(q, k, v, lengths, implementation="xla"))
    want = np.asarray(xla_attention(q, k, v, bias))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5)


def test_padded_attention_gradient_matches_f32_xla():
    """The gradient through the padded call equals the einsum chain's on
    the valid rows (padded query rows carry no loss)."""
    import jax
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import (
        padded_attention, seq_lengths, xla_attention)

    q, k, v = _qkv(2)
    mask = _mask_for(_PAD_PATTERNS["mixed"])
    bias = jnp.asarray(np.where(mask, 0.0, -1e9)[:, None, None, :],
                       jnp.float32)
    lengths = seq_lengths(jnp.asarray(mask))
    probe = jnp.asarray(mask, jnp.float32)[:, :, None, None] * _qkv(3)[0]

    def loss(fn):
        return lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * probe)

    g_got = jax.grad(loss(lambda a, b, c: padded_attention(
        a, b, c, lengths, implementation="xla")), argnums=(0, 1, 2))(q, k, v)
    g_want = jax.grad(loss(lambda a, b, c: xla_attention(a, b, c, bias)),
                      argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_seq_lengths_from_right_padded_mask():
    """Mask -> cuDNN sequence lengths: the count of valid tokens, clamped
    to 1 so an all-padding batch-fill row still attends somewhere."""
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import seq_lengths

    mask = np.zeros((4, 8), np.int32)
    mask[0] = 1
    mask[1, :3] = 1
    mask[2, :1] = 1
    lengths = np.asarray(seq_lengths(jnp.asarray(mask)))
    assert lengths.dtype == np.int32
    np.testing.assert_array_equal(lengths, [8, 3, 1, 1])


@pytest.mark.parametrize("platform,impl,dtype,want", [
    ("gpu", "auto", "bfloat16", "cudnn"),
    ("gpu", "auto", "float32", "xla"),
    ("cpu", "auto", "bfloat16", "xla"),
    ("cpu", "xla_bf16", "bfloat16", "xla_bf16"),
    ("gpu", "xla", "bfloat16", "xla"),
])
def test_resolve_attention_impl_by_platform(platform, impl, dtype, want):
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import resolve_attention_impl

    assert resolve_attention_impl(impl, jnp.dtype(dtype), platform) == want


def test_resolve_attention_impl_rejects_unknown():
    from better_search_rag_rust_tpu.models.nomic import resolve_attention_impl

    with pytest.raises(ValueError, match="attention_impl"):
        resolve_attention_impl("fused")
    with pytest.raises(ValueError, match="platform"):
        resolve_attention_impl("auto", platform="metal")


def test_cudnn_attention_raises_off_gpu():
    """Asking for cuDNN where there is none fails loudly — no silent
    fallback to another implementation."""
    cfg = NomicBertConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
        mlp_dim=32, max_tokens=8, attention_impl="cudnn",
    )
    enc = NomicEncoder(cfg, seed=0)
    with pytest.raises(Exception, match="(?i)cudnn"):
        enc.encode_tokens(np.ones((1, 8), np.int32), np.ones((1, 8), np.int32))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_init_params_tree_matches_hf_conversion(activation):
    """``init_params`` builds exactly the tree ``convert_hf_params`` fills
    (names, shapes, float32), so a random-init model and a checkpoint are
    interchangeable."""
    import jax

    from better_search_rag_rust_tpu.models.nomic import (
        convert_hf_params, init_params)

    cfg = NomicBertConfig(
        vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
        mlp_dim=32, max_tokens=8, activation=activation,
    )
    d, m = cfg.hidden_size, cfg.mlp_dim
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    state = {
        "embeddings.word_embeddings.weight": w(cfg.vocab_size, d),
        "embeddings.token_type_embeddings.weight": w(2, d),
        "emb_ln.weight": w(d), "emb_ln.bias": w(d),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        state.update({
            f"{pre}.attn.Wqkv.weight": w(3 * d, d),
            f"{pre}.attn.out_proj.weight": w(d, d),
            f"{pre}.attn.out_proj.bias": w(d),
            f"{pre}.norm1.weight": w(d), f"{pre}.norm1.bias": w(d),
            f"{pre}.norm2.weight": w(d), f"{pre}.norm2.bias": w(d),
            f"{pre}.mlp.fc2.weight": w(d, m), f"{pre}.mlp.fc2.bias": w(d),
        })
        if activation == "swiglu":
            state[f"{pre}.mlp.fc1.weight"] = w(2 * m, d)
        else:
            state[f"{pre}.mlp.fc1.weight"] = w(m, d)
            state[f"{pre}.mlp.fc1.bias"] = w(m)
    shapes = lambda t: jax.tree.map(lambda x: (x.shape, str(x.dtype)), t)
    assert shapes(init_params(cfg, seed=3)) == shapes(
        convert_hf_params(state, cfg))


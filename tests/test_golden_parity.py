"""Numerical-parity proof for the NomicBERT port (VERDICT round 1, item 2).

The real nomic-embed-text-v1.5 checkpoint is not obtainable in this
zero-egress environment (and the reference's own model tests skip without
the on-disk artifact, src/llm/hf.rs:138-144), so the strongest available
proof is a **double implementation**: an independent PyTorch forward written
directly from the architecture spec (NeoX rotary base-1000 non-interleaved,
post-LN blocks, fused-GLU fc1 splitting as (y, gate), masked mean-pool,
affine-free layernorm, L2) evaluated on an HF-format synthetic checkpoint —
fused ``mlp.fc1`` tensors plus ``bert.``-prefixed names, so
``convert_hf_params``'s split and prefix-strip paths are on the line too.
Any divergence in rotary interleaving, GLU split order, pooling or layernorm
placement makes the two disagree.

A committed golden fixture (``tests/golden/nomic_golden.npz``, generated by
the torch implementation) additionally pins the JAX forward against future
regressions without needing torch at test time. When a real checkpoint
export IS present (BSR_CHECKPOINT_DIR), the same cross-check runs against
the real weights.
"""

import os
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden" / "nomic_golden.npz"

# Small but structurally faithful config: even head_dim, fused GLU, 2 types.
CFG = dict(vocab_size=503, hidden_size=64, num_layers=3, num_heads=4,
           mlp_dim=96, max_tokens=48, rotary_base=1000.0)


def synth_hf_state(seed: int = 7):
    """HF-format nomic-bert state dict: bert.-prefixed, fused mlp.fc1."""
    rng = np.random.default_rng(seed)
    d, inner, L = CFG["hidden_size"], CFG["mlp_dim"], CFG["num_layers"]

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    state = {
        "bert.embeddings.word_embeddings.weight": w(CFG["vocab_size"], d),
        "bert.embeddings.token_type_embeddings.weight": w(2, d),
        "bert.emb_ln.weight": 1.0 + w(d),
        "bert.emb_ln.bias": w(d),
    }
    for i in range(L):
        p = f"bert.encoder.layers.{i}"
        state[f"{p}.attn.Wqkv.weight"] = w(3 * d, d)
        state[f"{p}.attn.out_proj.weight"] = w(d, d)
        state[f"{p}.attn.out_proj.bias"] = w(d)
        state[f"{p}.mlp.fc1.weight"] = w(2 * inner, d)  # fused (y, gate)
        state[f"{p}.mlp.fc2.weight"] = w(d, inner)
        state[f"{p}.mlp.fc2.bias"] = w(d)
        state[f"{p}.norm1.weight"] = 1.0 + w(d)
        state[f"{p}.norm1.bias"] = w(d)
        state[f"{p}.norm2.weight"] = 1.0 + w(d)
        state[f"{p}.norm2.bias"] = w(d)
    return state


def sample_tokens(seed: int = 11, batch: int = 6):
    rng = np.random.default_rng(seed)
    s = CFG["max_tokens"]
    ids = rng.integers(3, CFG["vocab_size"], size=(batch, s)).astype(np.int32)
    mask = np.zeros((batch, s), np.int32)
    for b in range(batch):
        n = int(rng.integers(5, s + 1))
        mask[b, :n] = 1
        ids[b, n:] = 0
    return ids, mask


def torch_nomic_forward(state, ids, mask):
    """Independent PyTorch forward, written from the architecture spec (NOT
    from models/nomic.py): HF nomic-bert semantics in f32."""
    import torch
    import torch.nn.functional as F

    st = {k.removeprefix("bert."): torch.tensor(v) for k, v in state.items()}
    d, L = CFG["hidden_size"], CFG["num_layers"]
    h = CFG["num_heads"]
    hd = d // h
    eps = 1e-12
    ids_t = torch.tensor(ids, dtype=torch.long)
    mask_t = torch.tensor(mask, dtype=torch.float32)

    x = st["embeddings.word_embeddings.weight"][ids_t]
    x = x + st["embeddings.token_type_embeddings.weight"][0]
    x = F.layer_norm(x, (d,), st["emb_ln.weight"], st["emb_ln.bias"], eps)

    # NeoX rotary tables, base from the nomic config (1000, not 10000).
    s = ids.shape[1]
    inv = 1.0 / (CFG["rotary_base"] ** (np.arange(0, hd, 2) / hd))
    freqs = np.outer(np.arange(s), inv)
    cos = torch.tensor(np.cos(freqs), dtype=torch.float32)  # [S, hd/2]
    sin = torch.tensor(np.sin(freqs), dtype=torch.float32)

    def rope(t):  # [B, S, H, hd], non-interleaved halves
        t1, t2 = t[..., : hd // 2], t[..., hd // 2:]
        c = cos[None, :, None, :]
        si = sin[None, :, None, :]
        return torch.cat([t1 * c - t2 * si, t2 * c + t1 * si], dim=-1)

    bias = (1.0 - mask_t)[:, None, None, :] * -1e9
    for i in range(L):
        p = f"encoder.layers.{i}"
        qkv = x @ st[f"{p}.attn.Wqkv.weight"].T
        b_, s_ = qkv.shape[:2]
        qkv = qkv.view(b_, s_, 3, h, hd)
        q, k, v = rope(qkv[:, :, 0]), rope(qkv[:, :, 1]), qkv[:, :, 2]
        logits = torch.einsum("bshd,bthd->bhst", q, k) / (hd ** 0.5) + bias
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b_, s_, d)
        attn = ctx @ st[f"{p}.attn.out_proj.weight"].T + st[f"{p}.attn.out_proj.bias"]
        x = F.layer_norm(x + attn, (d,), st[f"{p}.norm1.weight"],
                         st[f"{p}.norm1.bias"], eps)
        fused = st[f"{p}.mlp.fc1.weight"]  # [2*inner, d], splits (y, gate)
        inner = fused.shape[0] // 2
        y = x @ fused[:inner].T
        gate = x @ fused[inner:].T
        mlp = (y * F.silu(gate)) @ st[f"{p}.mlp.fc2.weight"].T + st[f"{p}.mlp.fc2.bias"]
        x = F.layer_norm(x + mlp, (d,), st[f"{p}.norm2.weight"],
                         st[f"{p}.norm2.bias"], eps)

    pooled = (x * mask_t[:, :, None]).sum(1) / mask_t.sum(1, keepdim=True).clamp(min=1)
    pooled = F.layer_norm(pooled, (d,))  # v1.5: affine-free LN before L2
    out = pooled / pooled.norm(dim=-1, keepdim=True)
    return out.numpy()


def flax_forward(state, ids, mask):
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import (
        NomicBertConfig,
        NomicEncoder,
        convert_hf_params,
    )

    cfg = NomicBertConfig(dtype=jnp.float32, attention_impl="xla", **CFG)
    params = convert_hf_params(state, cfg)
    enc = NomicEncoder(cfg, params=params)
    return enc.encode_tokens(ids, mask)


def test_flax_matches_independent_torch_implementation():
    """Double-implementation agreement: rotary / GLU-split / pooling bugs in
    either implementation break this (reference parity anchor:
    src/llm/hf.rs:109-121 — the model's actual numbers ARE the contract)."""
    state = synth_hf_state()
    ids, mask = sample_tokens()
    want = torch_nomic_forward(state, ids, mask)
    got = flax_forward(state, ids, mask)
    cos = np.sum(want * got, axis=-1)  # both L2-normalized
    assert cos.min() > 0.99999, cos
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_flax_matches_committed_golden():
    """Regression pin: the committed golden embeddings were produced by the
    independent torch implementation; the JAX forward must keep matching
    them bit-for-bit-ish across refactors."""
    assert GOLDEN.exists(), (
        "golden fixture missing — regenerate with scripts/gen_golden.py"
    )
    blob = np.load(GOLDEN)
    state = synth_hf_state(int(blob["state_seed"]))
    got = flax_forward(state, blob["ids"], blob["mask"])
    want = blob["embeddings"]
    cos = np.sum(want * got, axis=-1)
    assert cos.min() > 0.99999, cos
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_tokenizer_parity_ids_golden():
    """Tokenizer-side pin: fixed texts -> fixed ids for the hermetic
    tokenizer, and the real-tokenizer path is pinned to
    add_special_tokens=False (the reference encodes with
    encode_batch(texts, false), src/llm/hf.rs:83)."""
    from better_search_rag_rust_tpu.models.tokenizer import (
        FixedLengthTokenizer,
        HashingTokenizer,
    )

    tok = HashingTokenizer(vocab_size=1000, max_tokens=16)
    ids, mask = tok.encode_batch(["hello world", "hello world"])
    np.testing.assert_array_equal(ids[0], ids[1])
    assert ids[0, 0] == HashingTokenizer.CLS_ID

    assert FixedLengthTokenizer.__init__.__defaults__[-1] is False  # parity


@pytest.mark.skipif(
    not os.environ.get("BSR_CHECKPOINT_DIR"),
    reason="real checkpoint export not present (zero-egress environment)",
)
def test_real_checkpoint_cross_implementation():
    """When a real nomic-embed-text-v1.5 export exists on disk, the same
    double-implementation check runs against the real weights: a torch
    forward through the checkpoint's own modeling code (when transformers
    can load it) vs the JAX forward, on the checkpoint's own tokenizer."""
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import (
        NomicEncoder,
        load_hf_checkpoint,
    )
    from better_search_rag_rust_tpu.models.tokenizer import load_tokenizer

    ckpt = os.environ["BSR_CHECKPOINT_DIR"]
    cfg, params = load_hf_checkpoint(ckpt)
    enc = NomicEncoder(
        type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32,
                     "attention_impl": "xla"}),
        params=params,
    )
    texts = [
        "public class VectorStore { void append(float[] row) {} }",
        "def cosine(a, b): return a @ b",
    ]
    tok = load_tokenizer(ckpt, cfg.max_tokens, cfg.vocab_size,
                         add_special_tokens=True)
    ids, mask = tok.encode_batch(texts)
    got = enc.encode_tokens(ids, mask)
    assert got.shape == (2, cfg.hidden_size)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(
        np.linalg.norm(got, axis=1), 1.0, atol=1e-3
    )  # mean-pool + L2 normalize contract

    # Cross-implementation diff through the checkpoint's own torch modeling
    # code — the definitive parity check (reference: src/llm/hf.rs:109-121,
    # the model's numbers ARE the contract).
    try:
        import torch
        from transformers import AutoModel
    except ImportError:
        torch = None
    if torch is not None:
        try:
            hf = AutoModel.from_pretrained(ckpt, trust_remote_code=True)
        except Exception:
            hf = None  # export without modeling code; JAX checks stand
        if hf is not None:
            hf.eval()
            with torch.no_grad():
                out = hf(
                    input_ids=torch.from_numpy(ids.astype(np.int64)),
                    attention_mask=torch.from_numpy(mask.astype(np.int64)),
                )
            h = out.last_hidden_state.numpy()
            m = mask[..., None].astype(np.float32)
            want = (h * m).sum(1) / np.maximum(m.sum(1), 1e-9)
            want = want / np.linalg.norm(want, axis=1, keepdims=True)
            cos = np.sum(want * got, axis=-1)
            assert cos.min() > 0.999, cos

    # Tokenizer-id diff vs the canonical tokenizer (padding + truncation +
    # special-token policy), when transformers ships one for the export.
    try:
        from transformers import AutoTokenizer

        canon = AutoTokenizer.from_pretrained(ckpt)
    except Exception:
        canon = None
    if canon is not None:
        ref = canon(
            texts, padding="max_length", truncation=True,
            max_length=cfg.max_tokens, return_tensors="np",
        )
        np.testing.assert_array_equal(ids, ref["input_ids"].astype(np.int32))
        np.testing.assert_array_equal(
            mask, ref["attention_mask"].astype(np.int32)
        )

    # Matryoshka truncation: the served truncate+renormalize path must
    # equal the full embedding sliced and renormalized (v1.5 is
    # Matryoshka-trained; 256 on the real 768-wide checkpoint, scaled
    # down for narrow synthetic exports so the chain test can drive this).
    mdim = min(256, cfg.hidden_size // 2)
    enc256 = NomicEncoder(
        type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32,
                     "attention_impl": "xla"}),
        params=params,
        matryoshka_dim=mdim,
    )
    got256 = enc256.encode_tokens(ids, mask)
    assert got256.shape == (2, mdim)
    sliced = got[:, :mdim]
    sliced = sliced / np.linalg.norm(sliced, axis=1, keepdims=True)
    np.testing.assert_allclose(got256, sliced, atol=5e-4)

"""Contrastive trainer: sharding specs, loss descent, driver entry points."""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from better_search_rag_rust_tpu.models.nomic import NomicBertConfig
from better_search_rag_rust_tpu.models.train import (
    ContrastiveTrainer,
    info_nce_loss,
    param_specs,
    shard_params,
)
from better_search_rag_rust_tpu.parallel import create_mesh


@pytest.fixture(scope="module")
def tiny_cfg():
    return NomicBertConfig(
        vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
        mlp_dim=64, max_tokens=8,
    )


@pytest.fixture(scope="module")
def dp_tp_mesh():
    return create_mesh(shape=(4, 2), axis_names=("data", "model"))


def test_param_specs_tp_layout(tiny_cfg):
    from better_search_rag_rust_tpu.models.nomic import init_params

    params = init_params(tiny_cfg, seed=0)
    specs = param_specs(params)
    l0 = specs["layer_0"]
    # column-parallel: output features sharded
    assert l0["attn"]["Wqkv"]["kernel"] == P(None, "model")
    assert l0["mlp"]["fc11"]["kernel"] == P(None, "model")
    assert l0["mlp"]["fc12"]["kernel"] == P(None, "model")
    # row-parallel: input features sharded
    assert l0["attn"]["out_proj"]["kernel"] == P("model", None)
    assert l0["mlp"]["fc2"]["kernel"] == P("model", None)
    # replicated everything else
    assert specs["word_embeddings"]["embedding"] == P()
    assert l0["norm1"]["scale"] == P()
    assert l0["attn"]["out_proj"]["bias"] == P()


def test_shard_params_places_on_mesh(tiny_cfg, dp_tp_mesh):
    from better_search_rag_rust_tpu.models.nomic import init_params

    params = init_params(tiny_cfg, seed=0)
    sharded = shard_params(params, dp_tp_mesh)
    kern = sharded["layer_0"]["attn"]["Wqkv"]["kernel"]
    assert kern.sharding.spec == P(None, "model")


def test_info_nce_identity_pairs_low_loss():
    import jax.numpy as jnp

    emb = jnp.eye(8, 16)
    loss_same = info_nce_loss(emb, emb, temperature=0.05)
    rolled = jnp.roll(emb, 1, axis=0)
    loss_diff = info_nce_loss(emb, rolled, temperature=0.05)
    assert float(loss_same) < float(loss_diff)


def test_train_step_decreases_loss(tiny_cfg, dp_tp_mesh):
    trainer = ContrastiveTrainer(tiny_cfg, dp_tp_mesh, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, size=(8, 8)).astype(np.int32)
    mask = np.ones((8, 8), np.int32)
    losses = [trainer.train_step(ids, mask, ids, mask) for _ in range(4)]
    assert losses[-1] < losses[0]
    assert int(trainer.state.step) == 4
    assert np.isfinite(losses).all()


REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)


def test_graft_entry_compiles():
    import sys

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out_shape = jax.eval_shape(fn, *args)
    assert out_shape.shape == (8, 768)


def test_graft_dryrun_multichip():
    import sys

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_checkpoint_roundtrip_preserves_sharding(tiny_cfg, dp_tp_mesh, tmp_path):
    import numpy as np

    from better_search_rag_rust_tpu.models.checkpoint import (
        load_params,
        save_params,
    )
    from jax.sharding import PartitionSpec as P

    trainer = ContrastiveTrainer(tiny_cfg, dp_tp_mesh)
    path = tmp_path / "ckpt"
    save_params(path, trainer.state.params)
    restored = load_params(path, like=trainer.state.params)
    orig = jax.device_get(trainer.state.params["layer_0"]["attn"]["Wqkv"]["kernel"])
    back = jax.device_get(restored["layer_0"]["attn"]["Wqkv"]["kernel"])
    np.testing.assert_array_equal(orig, back)
    assert restored["layer_0"]["attn"]["Wqkv"]["kernel"].sharding.spec == P(None, "model")

    # resume training from the restored params
    resumed = ContrastiveTrainer(tiny_cfg, dp_tp_mesh, params=restored)
    ids = np.ones((8, 8), np.int32)
    loss = resumed.train_step(ids, ids * 0 + 1, ids, ids * 0 + 1)
    assert np.isfinite(loss)


def test_corpus_pair_batches(tmp_path):
    import numpy as np

    from better_search_rag_rust_tpu.models.tokenizer import HashingTokenizer
    from better_search_rag_rust_tpu.models.train_data import (
        corpus_pair_batches,
        pairs_from_texts,
    )

    root = tmp_path / "src"
    root.mkdir()
    for i in range(9):
        body = " ".join(f"tok{i}_{j}" for j in range(40))
        (root / f"F{i}.java").write_text(f"class F{i} {{ {body} }}")
    tok = HashingTokenizer(vocab_size=512, max_tokens=16)

    batches = list(corpus_pair_batches(
        str(root), ("java",), tok, batch_size=4, epochs=2))
    assert len(batches) == 4  # 9 files -> 2 full batches/epoch x 2 epochs
    a_ids, a_mask, p_ids, p_mask = batches[0]
    assert a_ids.shape == (4, 16) and p_ids.shape == (4, 16)
    # multi-window files: anchor and positive are different windows
    texts = [" ".join(f"w{j}" for j in range(100))]
    a_i, a_m, p_i, p_m = pairs_from_texts(texts, tok, seed=1)
    assert not np.array_equal(a_i, p_i)
    # determinism
    b2 = list(corpus_pair_batches(str(root), ("java",), tok, 4, epochs=1))
    np.testing.assert_array_equal(batches[0][0], b2[0][0])


def test_cli_finetune(tmp_path, capsys):
    from better_search_rag_rust_tpu.cli import main

    root = tmp_path / "src"
    root.mkdir()
    for i in range(8):
        (root / f"F{i}.java").write_text(
            f"class F{i} {{ " + " ".join(f"m{i}_{j}" for j in range(30)) + " }}"
        )
    rc = main([
        "finetune", "--root", str(root), "--steps", "3",
        "--train-batch", "4", "--tp", "2",
        "--dim", "32", "--max-tokens", "16", "--encoder-backend", "hash",
        "--num-layers", "1", "--num-heads", "2", "--mlp-dim", "64",
        "--save-dir", str(tmp_path / "ckpt"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final loss" in out
    assert (tmp_path / "ckpt").exists()


def test_sequence_parallel_train_step(tiny_cfg, dp_tp_mesh):
    """SP over the TP axis: activations shard their sequence dim across
    'model' in the norm regions. Loss must track the non-SP trainer within
    reduction-order noise and decrease."""
    import numpy as np

    rng = np.random.default_rng(3)
    ids = rng.integers(1, 128, size=(8, 8)).astype(np.int32)
    mask = np.ones((8, 8), np.int32)

    tr_sp = ContrastiveTrainer(tiny_cfg, dp_tp_mesh, learning_rate=1e-3,
                               sequence_parallel=True)
    assert tr_sp.config.sp_mesh_axes == ("data", "model")
    losses = [tr_sp.train_step(ids, mask, ids, mask) for _ in range(3)]
    assert losses[-1] < losses[0]

    tr_ns = ContrastiveTrainer(tiny_cfg, dp_tp_mesh, learning_rate=1e-3,
                               sequence_parallel=False)
    assert tr_ns.config.sp_mesh_axes is None
    l0 = tr_ns.train_step(ids, mask, ids, mask)
    assert abs(losses[0] - l0) < 1e-2  # reduction-order noise only


def test_dp_tp_train_step_matches_single_device(tiny_cfg, dp_tp_mesh):
    """One DP x TP step (batch over 'data', Megatron kernels over 'model',
    sequence parallelism) computes the loss of the same step on one device
    (within reduction-order noise) — the multi-card training contract."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 128, size=(8, 8)).astype(np.int32)
    mask = np.ones((8, 8), np.int32)
    mask[3, 5:] = 0
    one = create_mesh(shape=(1, 1), axis_names=("data", "model"),
                      devices=jax.devices()[:1])
    l_one = ContrastiveTrainer(tiny_cfg, one).train_step(ids, mask, ids, mask)
    l_mesh = ContrastiveTrainer(tiny_cfg, dp_tp_mesh).train_step(
        ids, mask, ids, mask)
    assert abs(l_mesh - l_one) <= 1e-2 * abs(l_one)


def test_checkpoint_load_without_template_is_host_tree(tiny_cfg, tmp_path):
    """Without ``like`` the checkpoint loads as the same nested tree of host
    float32 arrays."""
    from better_search_rag_rust_tpu.models.checkpoint import (
        load_params,
        save_params,
    )
    from better_search_rag_rust_tpu.models.nomic import init_params

    params = init_params(tiny_cfg, seed=5)
    save_params(tmp_path / "ck", params)
    back = load_params(tmp_path / "ck")
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


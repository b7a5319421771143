"""Pre-LN encoder option (ModelConfig.norm_style).

Post-LN (the reference block order, transformer.py:202-213) collapses at
6 layers on Beauty under every LR measured (BASELINE.md round 4); pre-LN is
the standard depth-stable variant. These tests pin:

* the default stays post-LN with an unchanged param tree,
* pre-LN adds exactly the final LN and changes the math,
* deep pre-LN gradients are finite and flow to the bottom layer,
* the hand-written tp_spmd encoder matches the flax encoder under pre-LN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.training.train_state import TrainState, make_optimizer
from bert4clickpath.training import schedules


def _cfg(norm_style="post", num_layers=2):
    return ModelConfig(
        features={"items": FeatureConfig(64, 16)},
        num_layers=num_layers,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        head=HeadConfig("tied_softmax"),
        norm_style=norm_style,
    )


def _batch(b=4, l=23, p=10):
    rng = np.random.default_rng(0)
    feats = {"items": jnp.asarray(rng.integers(10, 60, (b, l)), jnp.int32)}
    pos = jnp.asarray(rng.integers(2, l, (b, p)), jnp.int32)
    return feats, pos


def test_pre_ln_adds_final_ln_and_changes_math():
    feats, pos = _batch()
    post = ClickstreamModel(_cfg("post"))
    pre = ClickstreamModel(_cfg("pre"))
    key = {"params": jax.random.PRNGKey(0)}
    p_post = post.init(key, feats, pos)["params"]
    p_pre = pre.init(key, feats, pos)["params"]
    assert "ln_final" not in p_post["encoder"]  # default tree unchanged
    assert "ln_final" in p_pre["encoder"]
    # per-layer trees are name-compatible (ln1/ln2 reused)
    assert set(p_pre["encoder"]["layer_0"]) == set(p_post["encoder"]["layer_0"])

    out_post = post.apply({"params": p_post}, feats, pos)
    # run pre-LN with the post-LN weights (+ its own ln_final): same shapes,
    # different function
    out_pre = pre.apply({"params": p_pre}, feats, pos)
    assert out_pre.shape == out_post.shape
    assert not np.allclose(np.asarray(out_pre), np.asarray(out_post))


def test_pre_ln_deep_grads_finite_and_flow():
    """6 layers: every param (including layer_0) gets a finite, nonzero grad."""
    from bert4clickpath.ops.losses import masked_softmax_cross_entropy

    feats, pos = _batch()
    labels = jnp.asarray(
        np.random.default_rng(1).integers(0, 50, (4, 10)), jnp.int32
    )
    model = ClickstreamModel(_cfg("pre", num_layers=6))
    params = model.init({"params": jax.random.PRNGKey(0)}, feats, pos)["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, feats, pos)
        return masked_softmax_cross_entropy(logits[..., :53], labels)

    grads = jax.grad(loss_fn)(params)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert leaves
    for path, g in leaves:
        names = "/".join(str(getattr(k, "key", k)) for k in path)
        assert np.isfinite(np.asarray(g)).all(), names
    # gradient reaches the bottom layer's attention kernel
    g0 = grads["encoder"]["layer_0"]["mha"]["wq"]["kernel"]
    assert float(jnp.abs(g0).max()) > 0


def test_norm_style_json_roundtrip_and_validation():
    cfg = _cfg("pre")
    assert ModelConfig.from_json(cfg.to_json()).norm_style == "pre"
    # configs serialized before the field existed default to post
    import json

    d = json.loads(cfg.to_json())
    del d["norm_style"]
    assert ModelConfig.from_json(json.dumps(d)).norm_style == "post"
    try:
        _cfg("sandwich")
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_tp_spmd_pre_ln_trajectory_matches_spmd_tier():
    """2 steps of the composed Megatron tier == 2 steps of the
    replicated-encoder SPMD tier under pre-LN: the hand-written TPEncoderApply
    must mirror the flax encoder's pre-LN block order (incl. ln_final)."""
    import test_parallel as tp_tests
    from bert4clickpath.parallel import spmd, tp_spmd

    mesh, ds, vocab, cfg = tp_tests._tp_spmd_setup()
    cfg = dataclasses.replace(cfg, norm_style="pre")
    model = ClickstreamModel(cfg)
    b0 = tp_tests._device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )["params"]
    assert "ln_final" in params["encoder"]
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)
    batches = [b0] + [
        tp_tests._device_batch(b)
        for _, b in zip(range(1), ds.train_batches(8, seed=2))
    ]

    ref_step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    ref_state = spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    want = []
    for b in batches:
        ref_state, loss = ref_step(ref_state, spmd.shard_batch(b, mesh, cfg), rng)
        want.append(float(loss))

    step = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    state = tp_spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    got = []
    for b in batches:
        state, loss = step(state, spmd.shard_batch(b, mesh, cfg), rng)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)

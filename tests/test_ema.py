"""EMA (Polyak-averaged) eval params: math, trainer routing, checkpoint
compatibility, and SPMD/DP parity with the single-device update."""

import numpy as np
import jax
import jax.numpy as jnp

from bert4clickpath import TrainConfig
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    ema_update,
    eval_params,
    make_optimizer,
    make_train_step,
)

from tests.test_training import _setup, _to_device


def test_ema_update_hand_formula():
    ema = {"w": jnp.ones((3,))}
    params = {"w": jnp.full((3,), 5.0)}
    # step 0: ramp gives d = min(0.999, 1/10) = 0.1
    out = ema_update(ema, params, jnp.asarray(0), 0.999)
    np.testing.assert_allclose(np.asarray(out["w"]), 0.1 * 1.0 + 0.9 * 5.0)
    # large step: ramp saturates at decay
    out = ema_update(ema, params, jnp.asarray(100_000), 0.999)
    np.testing.assert_allclose(
        np.asarray(out["w"]), 0.999 * 1.0 + 0.001 * 5.0, rtol=1e-6
    )


def test_train_step_tracks_ema_and_eval_params_selects_it():
    ds, vocab, cfg, model = _setup()
    batch = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, batch["features"], batch["head_positions"]
    )
    tcfg = TrainConfig(batch_size=16)
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx, ema=True)
    step = make_train_step(model, tx, schedules.constant(1e-2), ema_decay=0.9)

    # replicate the EMA recurrence on the host from the actual param sequence
    expect = jax.device_get(params)
    s = state
    for t in range(3):
        s, _ = step(s, batch, jax.random.PRNGKey(1))
        d = min(0.9, (1.0 + t) / (10.0 + t))
        expect = jax.tree.map(
            lambda e, p: d * e + (1 - d) * np.asarray(p), expect, jax.device_get(s.params)
        )
    got = jax.device_get(s.ema_params)
    for e, g in zip(jax.tree.leaves(expect), jax.tree.leaves(got)):
        np.testing.assert_allclose(e, g, rtol=2e-5, atol=1e-6)
    # eval_params picks the shadow exactly
    for a, b in zip(jax.tree.leaves(eval_params(s)), jax.tree.leaves(s.ema_params)):
        assert a is b
    # and ema differs from the raw params (it lags them)
    diffs = [
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.device_get(s.params)))
    ]
    assert max(diffs) > 0


def test_ema_off_state_restores_old_checkpoints(tmp_path):
    # ema_params=None must keep the pytree structure of pre-EMA checkpoints:
    # save a None-ema state, restore into a fresh None-ema abstract state.
    ds, vocab, cfg, model = _setup()
    batch = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, batch["features"], batch["head_positions"]
    )
    tx = make_optimizer(TrainConfig(batch_size=8))
    state = TrainState.create(params, tx)
    assert state.ema_params is None
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), jax.device_get(state), 0)
    restored = ckpt_lib.restore_state(path, jax.device_get(state))
    assert restored.ema_params is None
    np.testing.assert_allclose(
        np.asarray(jax.tree.leaves(restored.params)[0]),
        np.asarray(jax.tree.leaves(state.params)[0]),
    )


def test_ema_state_checkpoint_roundtrip(tmp_path):
    ds, vocab, cfg, model = _setup()
    batch = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, batch["features"], batch["head_positions"]
    )
    tx = make_optimizer(TrainConfig(batch_size=8))
    state = TrainState.create(params, tx, ema=True)
    step = make_train_step(model, tx, schedules.constant(1e-2), ema_decay=0.9)
    state, _ = step(state, batch, jax.random.PRNGKey(1))
    host = jax.device_get(state)
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), host, 1)
    restored = ckpt_lib.restore_state(path, host)
    for a, b in zip(jax.tree.leaves(restored.ema_params), jax.tree.leaves(host.ema_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_spmd_ema_matches_single_device():
    # one sharded optimizer step with EMA == the single-device recurrence
    from bert4clickpath import MeshConfig
    from bert4clickpath.parallel import spmd
    from bert4clickpath.parallel.mesh import make_mesh

    from bert4clickpath import ClickstreamModel, FeatureConfig, HeadConfig, ModelConfig

    ds, vocab, _, _ = _setup()
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 2)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        num_layers=1,
        num_heads=1,
        ffn_dim=32,
        max_len=23,
        head=HeadConfig("tied_softmax"),
    )
    model = ClickstreamModel(cfg)
    batch = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, batch["features"], batch["head_positions"]
    )["params"]
    tcfg = TrainConfig(batch_size=16)
    tx = make_optimizer(tcfg)

    mesh = make_mesh(MeshConfig(data=4, model=2))
    state = TrainState.create(params, tx, ema=True)
    ema0 = jax.device_get(state.ema_params)  # before the donated step
    sh_state = spmd.shard_state(state, mesh, cfg)
    sh_batch = spmd.shard_batch(batch, mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size,
        ema_decay=0.9,
    )
    sh_state, _ = step(sh_state, sh_batch, jax.random.PRNGKey(1))
    got = jax.device_get(sh_state.ema_params)
    # recompute on host from the updated params: d(step 0) = 0.1
    expect = jax.tree.map(
        lambda e, p: 0.1 * np.asarray(e) + 0.9 * np.asarray(p),
        ema0,
        jax.device_get(sh_state.params),
    )
    for e, g in zip(jax.tree.leaves(expect), jax.tree.leaves(got)):
        np.testing.assert_allclose(e, np.asarray(g), rtol=2e-5, atol=1e-6)

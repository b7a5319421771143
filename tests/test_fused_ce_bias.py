"""Bias-carrying fused CE (ops/fused_ce.fused_softmax_ce_bias) vs the
dense oracle, and the fused-MLP-head train/eval paths vs the dense logits
paths.

The bias variant serves the reference's parity MLP softmax head (its final
Dense(V) has a bias, head.py:29-47) and tied heads with a free
per-item output bias — both previously dense-logits-only.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath.config import FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath.constants import LABEL_PAD
from bert4clickpath.models.model import ClickstreamModel
from bert4clickpath.ops.fused_ce import (
    _labels_model,
    _xla_bwd,
    fused_softmax_ce_bias,
)
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.schedules import constant


def _case(n=16, d=8, v=64, row_offset=10, num_valid=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32)
    labels = rng.integers(0, num_valid, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    return (
        jnp.asarray(x),
        jnp.asarray(table),
        jnp.asarray(bias),
        jnp.asarray(labels),
        row_offset,
        num_valid,
    )


def _dense_nll_bias(x, table, bias, labels, row_offset, num_valid):
    w = table[row_offset : row_offset + num_valid]
    b = bias[row_offset : row_offset + num_valid]
    logits = x @ w.T + b[None, :]
    logz = jax.nn.logsumexp(logits, axis=-1)
    safe = jnp.where(labels == LABEL_PAD, 0, labels)
    picked = jnp.take_along_axis(logits, safe[:, None], axis=1)[:, 0]
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    return (logz - picked) * mask


def test_forward_matches_dense():
    x, table, bias, labels, off, nv = _case()
    nll = fused_softmax_ce_bias(x, table, bias, labels, off, nv)
    want = _dense_nll_bias(x, table, bias, labels, off, nv)
    np.testing.assert_allclose(np.asarray(nll), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gradients_match_dense():
    x, table, bias, labels, off, nv = _case()

    def mean_of(nll):
        mask = (labels != LABEL_PAD).astype(jnp.float32)
        return jnp.sum(nll) / jnp.maximum(jnp.sum(mask), 1.0)

    def fused_loss(x, t, b):
        return mean_of(fused_softmax_ce_bias(x, t, b, labels, off, nv))

    def dense_loss(x, t, b):
        return mean_of(_dense_nll_bias(x, t, b, labels, off, nv))

    gf = jax.grad(fused_loss, argnums=(0, 1, 2))(x, table, bias)
    gd = jax.grad(dense_loss, argnums=(0, 1, 2))(x, table, bias)
    for got, want, name in zip(gf, gd, ("dx", "dw", "db")):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=name
        )
    # blinded rows (reserved/OOV/padding) must get exactly zero dw/db
    np.testing.assert_array_equal(np.asarray(gf[1][:off]), 0.0)
    np.testing.assert_array_equal(np.asarray(gf[2][off + nv :]), 0.0)


def test_chunked_bias_backward_matches_single_chunk(monkeypatch):
    """The bias backward over several scan chunks (db scattered per chunk)
    equals the one-chunk backward: chunking must not change dx, dW or db."""
    from bert4clickpath.ops import fused_ce as F

    x, table, bias, labels, off, nv = _case(n=24, v=512, num_valid=400)
    lab = _labels_model(labels, off)
    logits = x @ table.T + bias
    rows = jnp.arange(table.shape[0])
    blinded = jnp.where((rows >= off) & (rows < off + nv), logits, -1e30)
    logz = jax.nn.logsumexp(blinded, axis=-1)
    dnll = (labels != LABEL_PAD).astype(jnp.float32)
    lo, hi = jnp.int32(off), jnp.int32(off + nv)
    one = _xla_bwd(x, table, lab, logz, dnll, lo, hi, bias)
    monkeypatch.setattr(F, "_XLA_TILE_BYTES", 24 * 128 * 4)
    chunked = _xla_bwd(x, table, lab, logz, dnll, lo, hi, bias)
    for got, want, name in zip(chunked, one, ("dx", "dw", "db")):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=name
        )


def _mlp_cfg(v_label=120):
    return ModelConfig(
        features={"items": FeatureConfig(v_label + 11, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        dropout_rate=0.0,
        max_len=12,
        positional="sinusoidal",
        head=HeadConfig("softmax", (24, 8), v_label),
        dtype="float32",
    )


def _tied_bias_cfg(v_label=120):
    return ModelConfig(
        features={"items": FeatureConfig(v_label + 11, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        dropout_rate=0.0,
        max_len=12,
        positional="sinusoidal",
        head=HeadConfig("tied_softmax", (), v_label, tied_bias=True),
        dtype="float32",
    )


def _batch(cfg, b=8, l=12, p=4, seed=1):
    rng = np.random.default_rng(seed)
    v_rows = cfg.features["items"].vocab_rows
    items = rng.integers(10, v_rows, size=(b, l)).astype(np.int32)
    pos = rng.integers(0, l, size=(b, p)).astype(np.int32)
    labels = rng.integers(0, cfg.head.output_size, size=(b, p)).astype(np.int32)
    labels[:, -1] = LABEL_PAD
    return {
        "features": {"items": jnp.asarray(items)},
        "head_positions": jnp.asarray(pos),
        "labels": jnp.asarray(labels),
    }


def _one_step(cfg, fused):
    model = ClickstreamModel(cfg)
    batch = _batch(cfg)
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        batch["features"],
        batch["head_positions"],
    )
    tx = make_optimizer(type("C", (), {"adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-9}))
    state = TrainState.create(params, tx)
    step = make_train_step(
        model,
        tx,
        constant(1e-2),
        fused_ce_num_valid=cfg.head.output_size if fused else None,
    )
    new_state, loss = step(state, batch, jax.random.PRNGKey(3))
    return float(loss), jax.device_get(new_state.params)


def test_mlp_head_fused_step_matches_dense():
    cfg = _mlp_cfg()
    loss_f, params_f = _one_step(cfg, fused=True)
    loss_d, params_d = _one_step(cfg, fused=False)
    assert abs(loss_f - loss_d) < 1e-5
    flat_f = jax.tree_util.tree_leaves_with_path(params_f)
    flat_d = dict(
        (jax.tree_util.keystr(k), v)
        for k, v in jax.tree_util.tree_leaves_with_path(params_d)
    )
    for k, v in flat_f:
        ks = jax.tree_util.keystr(k)
        if "wk" in ks and "bias" in ks:
            # attention key bias cancels in softmax -> exactly-zero gradient;
            # Adam amplifies each path's float noise to +-lr (same exclusion
            # as tests/test_parallel.py's update-parity checks)
            continue
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_d[ks]),
            rtol=2e-4, atol=2e-5, err_msg=ks,
        )


def test_tied_bias_fused_step_matches_dense():
    cfg = _tied_bias_cfg()
    loss_f, params_f = _one_step(cfg, fused=True)
    loss_d, params_d = _one_step(cfg, fused=False)
    assert abs(loss_f - loss_d) < 1e-5
    bias_f = params_f["params"]["tied_out_bias"]
    bias_d = params_d["params"]["tied_out_bias"]
    assert np.any(np.asarray(bias_f) != 0.0), "bias must receive gradient"
    np.testing.assert_allclose(np.asarray(bias_f), np.asarray(bias_d), rtol=2e-4, atol=2e-5)


def test_chunked_eval_softmax_head_matches_dense():
    cfg = _mlp_cfg(v_label=120)
    model = ClickstreamModel(cfg)
    batch = _batch(cfg, seed=5)
    params = model.init(
        {"params": jax.random.PRNGKey(2)},
        batch["features"],
        batch["head_positions"],
    )
    dense = make_eval_step(model, ks=(5, 10))(params, batch)
    chunked = make_eval_step(
        model, ks=(5, 10), chunked_num_valid=cfg.head.output_size
    )(params, batch)
    for k in dense:
        np.testing.assert_allclose(
            np.asarray(dense[k]), np.asarray(chunked[k]),
            rtol=1e-4, atol=1e-5, err_msg=k,
        )

"""TP × vocab-sharded composition: Megatron-sharded encoder AND row-sharded
item table + fused vocab-parallel CE on ONE (data, model) mesh.

The two existing model-axis tiers each cover half the problem:

* ``parallel/tp.py`` shards the encoder (pjit auto-sharding) but runs the
  dense XLA loss — so it cannot train giant catalogs;
* ``parallel/spmd.py`` shards the catalog (shard_map + the fused CE's
  hand-written VJP) but replicates the encoder.

This module composes them: the encoder's QKV/FFN matmuls shard column/row-
wise over ``model`` exactly like tp.py, but expressed *inside* the same
shard_map program that runs the sharded embedding lookup and fused CE — so
a wide encoder and a 10M-item catalog share one mesh. Since shard_map runs
with replication checking off, every collective autodiff can see carries a
hand-written VJP: the Megatron f/g pair (parallel/collectives.py) inside
the encoder, and the existing lookup/CE VJPs (parallel/embedding.py,
ops/fused_ce.py) around it.

Sharding layout (S = model-axis size):

* wq/wk/wv kernels (D, D/S) column-sharded — each shard owns H/S heads and
  runs the per-head attention on its slice; wo (D/S, D)
  row-sharded with ONE all-reduce per layer (``psum_fwd``);
* ffn1 (D, F/S) column-sharded (+ its bias), ffn2 (F/S, D) row-sharded with
  one all-reduce; row-parallel biases are added once, after the reduce;
* LayerNorms / positions / tied transform replicated (identical math on
  every shard, so their grads replicate without a model-axis psum);
* the item table rows shard over ``model`` (spmd tier layout), and the tied
  projection runs the sharded fused CE.

All dropout sites in this encoder are on *replicated* tensors (dropout is
applied after the wo/ffn2 all-reduce — EncoderLayer's ``drop(...)`` wraps
each sublayer OUTPUT, both norm styles), so the step's
data-only rng folding keeps model shards bitwise identical, preserving the
replication invariant.

No reference equivalent (SURVEY §2.2: the reference has MirroredStrategy
only): a wide encoder and a vocab-sharded catalog sharing one mesh.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bert4clickpath.config import ModelConfig
from bert4clickpath.models import layers
from bert4clickpath.models.encoder import INPUT_DROPOUT_SALT, attention_per_head
from bert4clickpath.parallel import spmd
from bert4clickpath.parallel.collectives import psum_bwd, psum_fwd
from bert4clickpath.parallel.mesh import MODEL_AXIS
from bert4clickpath.parallel.tp import _names, _tp_spec
from bert4clickpath.training.train_state import TrainState
from bert4clickpath.utils.device import compute_dtype


def _dropout(x, rate: float, deterministic: bool, rng, salt: int):
    return layers.dropout(x, rate, None if deterministic else rng, salt)


class TPEncoderApply:
    """Tensor-parallel encoder forward, duck-typed to the Encoder's
    ``.apply({'params': p}, x, bias, deterministic, rngs=...)`` call so
    ``spmd._forward_gathered`` composes unchanged.

    Runs INSIDE shard_map: the param leaves it sees are the local slices
    that :func:`state_specs` placed on this device. The shard count is
    recovered from the kernel shapes (``wq`` local width = D/S), so the
    same object traces correctly on any model-axis size.
    """

    def __init__(self, config: ModelConfig, axis_name: str = MODEL_AXIS):
        self.config = config
        self.axis = axis_name
        self.dtype = compute_dtype(config)

    def apply(self, variables, x, bias, deterministic, rngs=None):
        params = variables["params"]
        cfg = self.config
        rng = None if rngs is None else rngs.get("dropout")
        x = _dropout(x, cfg.dropout_rate, deterministic, rng, INPUT_DROPOUT_SALT)
        for i in range(cfg.num_layers):
            x = self._layer(
                params[f"layer_{i}"], x, bias, deterministic, rng, i
            )
        if cfg.norm_style == "pre":
            x = layers.layer_norm(params["ln_final"], x, self.dtype)
        return x

    def _layer(self, p, x, bias, deterministic, rng, i):
        cfg, dtype = self.config, self.dtype
        mha = p["mha"]
        d_local = mha["wq"]["kernel"].shape[-1]
        local_heads = cfg.num_heads * d_local // cfg.d_model
        pre = cfg.norm_style == "pre"
        # --- attention: column-parallel QKV (H/S heads per shard), row-
        # parallel wo. psum_bwd marks the replicated->sharded fan-out so the
        # input cotangent is reassembled over the model axis.
        # pre-LN: LN the sublayer input (LN params replicated, math is
        # per-token, so it runs identically on every shard), residual un-LN'd.
        xin = psum_bwd(layers.layer_norm(p["ln1"], x, dtype) if pre else x, self.axis)
        qf = layers.dense(mha["wq"], xin, dtype)
        kf = layers.dense(mha["wk"], xin, dtype)
        vf = layers.dense(mha["wv"], xin, dtype)
        attn = attention_per_head(qf, kf, vf, bias, local_heads)
        # row-parallel wo: partial matmul, all-reduce, then the bias ONCE.
        # Partials accumulate in f32 (preferred_element_type) and the psum
        # runs in f32, so the full contraction is rounded to bf16 exactly
        # once — matching the single-device Dense path, whose XLA dot
        # accumulates the whole K dimension in f32 before the output cast.
        attn = self._row_parallel(attn, mha["wo"], dtype)
        attn = _dropout(attn, cfg.dropout_rate, deterministic, rng, 2 * i)
        x = x + attn if pre else layers.layer_norm(p["ln1"], x + attn, dtype)
        # --- ffn: column-parallel ffn1 (+ sharded bias), row-parallel ffn2
        fin = psum_bwd(layers.layer_norm(p["ln2"], x, dtype) if pre else x, self.axis)
        h = jax.nn.relu(layers.dense(p["ffn1"], fin, dtype))
        ffn = self._row_parallel(h, p["ffn2"], dtype)
        ffn = _dropout(ffn, cfg.dropout_rate, deterministic, rng, 2 * i + 1)
        return x + ffn if pre else layers.layer_norm(p["ln2"], x + ffn, dtype)

    def _row_parallel(self, x, p, dtype):
        """Row-parallel Dense: f32-accumulated local partial, f32 all-reduce,
        one rounding to ``dtype``, then the (replicated) bias — the bias adds
        in ``dtype`` after the cast, exactly like ``layers.dense``."""
        part = jax.lax.dot_general(
            x.astype(dtype),
            p["kernel"].astype(dtype),
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        out = psum_fwd(part, self.axis).astype(dtype)
        return out + p["bias"].astype(dtype)


def param_specs(params, config: ModelConfig):
    """Item table P(model, None) (spmd layout) + Megatron specs for the
    encoder kernels (tp layout); everything else replicated."""

    def spec(path, leaf):
        if spmd._is_sharded_table(path, config):
            return P(MODEL_AXIS, None)
        return _tp_spec(_names(path))

    return jax.tree_util.tree_map_with_path(spec, params)


def state_specs(state: TrainState, config: ModelConfig) -> TrainState:
    p_spec = param_specs(state.params, config)

    def opt_spec(path, leaf):
        if getattr(leaf, "ndim", 0) == 0:
            return P()
        if spmd._is_sharded_table(path, config) and leaf.ndim >= 2:
            return P(MODEL_AXIS, None)
        return _tp_spec(_names(path))

    o_spec = jax.tree_util.tree_map_with_path(opt_spec, state.opt_state)
    e_spec = (
        None
        if state.ema_params is None
        else param_specs(state.ema_params, config)
    )
    return TrainState(
        step=P(), params=p_spec, opt_state=o_spec, lr_scale=P(), ema_params=e_spec
    )


def shard_state(state: TrainState, mesh: Mesh, config: ModelConfig) -> TrainState:
    specs = state_specs(state, config)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def _check_supported(config: ModelConfig, mesh: Mesh) -> None:
    from bert4clickpath.parallel.support import validate_tier

    validate_tier("tp_spmd", config.head.kind, qkv_fused=config.qkv_fused)
    shards = mesh.shape[MODEL_AXIS]
    if config.num_heads % shards:
        raise ValueError(
            f"num_heads {config.num_heads} not divisible by model axis {shards}"
        )
    if config.ffn_dim % shards:
        raise ValueError(
            f"ffn_dim {config.ffn_dim} not divisible by model axis {shards}"
        )


def make_tp_spmd_train_step(
    config: ModelConfig,
    mesh: Mesh,
    tx: optax.GradientTransformation,
    schedule: Callable,
    label_vocab_size: int,
    ema_decay: float = 0.0,
    steps_per_call: int = 1,
):
    """Jitted composed train step: (state, batch, rng) -> (state, loss).

    Same contract as ``spmd.make_spmd_train_step`` (shard the state with
    :func:`shard_state`, batches with ``spmd.shard_batch`` /
    ``spmd.shard_stacked_batch``); the encoder now also shards over
    ``model``.
    """
    _check_supported(config, mesh)
    return spmd.make_spmd_train_step(
        config,
        mesh,
        tx,
        schedule,
        label_vocab_size,
        ema_decay=ema_decay,
        steps_per_call=steps_per_call,
        _encoder=TPEncoderApply(config),
        _specs_fn=lambda st: state_specs(st, config),
    )


def make_tp_spmd_eval_step(
    config: ModelConfig,
    mesh: Mesh,
    label_vocab_size: int,
    ks=(5, 10),
):
    """Composed eval step: sharded-encoder forward + per-shard chunked
    catalog scan (same stats contract as ``spmd.make_spmd_eval_step``)."""
    _check_supported(config, mesh)
    return spmd.make_spmd_eval_step(
        config,
        mesh,
        label_vocab_size,
        ks=ks,
        _encoder=TPEncoderApply(config),
        _param_specs_fn=lambda p: param_specs(p, config),
    )

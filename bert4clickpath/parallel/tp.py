"""Tensor-parallel tier: Megatron-style encoder sharding via XLA's SPMD
partitioner (the pjit/auto-sharding recipe).

The other two distribution tiers in this package are shard_map programs
with hand-written collectives: ``spmd.py`` (vocab-sharded tables + the
sharded fused-CE kernel) and the pure-DP tier. This module is the third,
fully idiomatic route — annotate parameter shardings on the same
('data', 'model') mesh and let XLA insert every collective:

- attention wq/wk/wv kernels shard **column-wise** over 'model'
  (head-parallel: each shard owns ``num_heads / model_shards`` heads),
  wo **row-wise** — one all-reduce after wo per layer;
- ffn1 shards column-wise (hidden dim split), ffn2 row-wise — one
  all-reduce after ffn2 per layer;
- biases follow their kernel's output sharding (column-parallel biases
  shard, row-parallel biases replicate);
- LayerNorms, embeddings, heads, and the optimizer state mirror of each
  leaf follow automatically;
- the batch shards over 'data', so this composes with data parallelism
  on the same mesh (a (dp, tp) grid).

The backward collectives fall out of autodiff — nothing hand-written.
This tier targets encoder-heavy shapes (large d_model / ffn_dim), the
SURVEY §2.2 "optional tp axis for head/FFN matmuls at large d_model" row.
It intentionally does NOT cover the vocab-sharded fused-CE path, whose
hand-written VJP needs shard_map: giant-catalog training belongs to
``spmd.make_spmd_train_step``; here the loss runs the dense XLA path and
tables stay replicated.

No reference equivalent: the reference's only distribution was
MirroredStrategy data parallelism (examples/BERT4Rec/source/main.py:46-57).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from bert4clickpath.config import ModelConfig
from bert4clickpath.parallel.mesh import MODEL_AXIS
from bert4clickpath.parallel.spmd import batch_specs
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_train_step,
)

# column-parallel projections: kernel (in, out) splits its OUTPUT dim,
# so the bias (out,) splits with it; row-parallel ones split the INPUT
# dim and keep a replicated bias (their outputs are partial-summed by
# the all-reduce XLA inserts)
_COL_PARALLEL = ("wq", "wk", "wv", "ffn1")
_ROW_PARALLEL = ("wo", "ffn2")


def _names(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path]


def _tp_spec(names: list) -> P:
    """Spec for one param path: column-parallel kernels split their output
    dim (bias splits with it), row-parallel kernels split their input dim
    (bias replicated — outputs are partial sums until the all-reduce)."""
    if "encoder" not in names:
        return P()
    for mod in _COL_PARALLEL:
        if mod in names:
            if "kernel" in names:
                return P(None, MODEL_AXIS)
            if "bias" in names:
                return P(MODEL_AXIS)
    for mod in _ROW_PARALLEL:
        if mod in names and "kernel" in names:
            return P(MODEL_AXIS, None)
    return P()


def tp_param_specs(params, config: ModelConfig):
    """PartitionSpec tree: encoder QKV/FFN kernels sharded over 'model',
    everything else replicated."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _tp_spec(_names(path)), params
    )


def tp_state_specs(state: TrainState, config: ModelConfig) -> TrainState:
    """Specs for the full TrainState: Adam moments shard with their params
    (optax state trees mirror the params tree, so the same path rule
    applies); scalars replicated."""
    p_spec = tp_param_specs(state.params, config)

    def opt_spec(path, leaf):
        # optax state trees mirror the params tree, so the same path rule
        # applies; scalars (e.g. the Adam step count) stay replicated
        if getattr(leaf, "ndim", 0) >= 1:
            return _tp_spec(_names(path))
        return P()

    o_spec = jax.tree_util.tree_map_with_path(opt_spec, state.opt_state)
    e_spec = (
        None
        if state.ema_params is None
        else tp_param_specs(state.ema_params, config)
    )
    return TrainState(
        step=P(), params=p_spec, opt_state=o_spec, lr_scale=P(), ema_params=e_spec
    )


def _check_tp_supported(model, mesh: Mesh) -> None:
    from bert4clickpath.parallel.support import validate_tier

    shards = mesh.shape[MODEL_AXIS]
    cfg = model.config
    if cfg.num_heads % shards:
        raise ValueError(
            f"num_heads {cfg.num_heads} not divisible by model axis {shards}"
        )
    if cfg.ffn_dim % shards:
        raise ValueError(
            f"ffn_dim {cfg.ffn_dim} not divisible by model axis {shards}"
        )
    # feature exclusions (qkv_fused, sampled softmax) live
    # in the shared tier matrix — parallel/support.py — so every tier errors
    # consistently
    validate_tier("tp", cfg.head.kind, qkv_fused=cfg.qkv_fused)


def shard_tp_state(state: TrainState, mesh: Mesh, config: ModelConfig) -> TrainState:
    specs = tp_state_specs(state, config)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def shard_tp_batch(batch: dict, mesh: Mesh, config: ModelConfig) -> dict:
    specs = batch_specs(config)
    return jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        batch,
        specs,
    )


def make_tp_train_step(
    model,
    tx: optax.GradientTransformation,
    schedule: Callable,
    mesh: Mesh,
    loss_fn: Optional[Callable] = None,
    ema_decay: float = 0.0,
    donate: bool = True,
):
    """Jit the standard single-program train step with TP shardings.

    The step body is ``train_state.make_train_step(raw=True)`` — jit
    semantics are global (the masked-mean loss normalizes over the whole
    batch), so no axis_name/psum is needed; the partitioner turns the
    sharding annotations into device programs + collectives.
    """
    _check_tp_supported(model, mesh)
    step = make_train_step(
        model, tx, schedule, loss_fn=loss_fn, ema_decay=ema_decay, raw=True
    )

    def shardings(state):
        sspec = jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            tp_state_specs(state, model.config),
            is_leaf=lambda x: isinstance(x, P),
        )
        bspec = jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            batch_specs(model.config),
            is_leaf=lambda x: isinstance(x, P),
        )
        return sspec, bspec

    cache = {}  # build the jit once (shardings need the state's tree shape)

    def jitted(state: TrainState, batch, rng):
        if "fn" not in cache:
            sspec, bspec = shardings(state)
            cache["fn"] = jax.jit(
                step,
                in_shardings=(sspec, bspec, NamedSharding(mesh, P())),
                out_shardings=(sspec, NamedSharding(mesh, P())),
                donate_argnums=(0,) if donate else (),
            )
        return cache["fn"](state, batch, rng)

    return jitted


def make_tp_eval_step(model, mesh: Mesh, ks=(5, 10), **kwargs):
    """TP-sharded eval step: same global-semantics trick as the train step."""
    _check_tp_supported(model, mesh)
    step = make_eval_step(model, ks=ks, raw=True, **kwargs)

    cache = {}

    def jitted(params, batch):
        if "fn" not in cache:
            pspec = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                tp_param_specs(params, model.config),
                is_leaf=lambda x: isinstance(x, P),
            )
            bspec = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                batch_specs(model.config),
                is_leaf=lambda x: isinstance(x, P),
            )
            cache["fn"] = jax.jit(step, in_shardings=(pspec, bspec))
        return cache["fn"](params, batch)

    return jitted

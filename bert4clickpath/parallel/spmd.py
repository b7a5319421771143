"""Explicit-SPMD train/eval steps over a (data, model) mesh via shard_map.

The multi-chip execution tier (SURVEY.md §2.2). Everything the reference
delegated to MirroredStrategy's hidden NCCL all-reduce (source/main.py:52)
is explicit here, expressed as XLA collectives:

* batch shards over ``data``; grads pmean over ``data``;
* the item embedding table row-shards over ``model``; lookups psum over
  ``model`` (parallel/embedding.py); the tied output projection never
  materializes full logits (vocab-parallel CE);
* loss/metric normalization is global by construction.

The optimizer update runs inside the same shard_map: Adam is elementwise, so
each device updates exactly the rows it owns — optimizer state shards with
the parameters (ZeRO-for-free on the big table).

Dropout: the PRNG key is folded with the ``data`` coordinate only, so model
shards (which redundantly compute the same replicated encoder) stay bitwise
identical while data shards decorrelate.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bert4clickpath.config import ModelConfig
from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS, SEP_ID
from bert4clickpath.models.encoder import Encoder
from bert4clickpath.models.model import ClickstreamModel
from bert4clickpath.models.positional import sinusoidal_positions
from bert4clickpath.ops.masking import padding_bias, segment_ids
from bert4clickpath.parallel import embedding as emb_ops
from bert4clickpath.parallel.mesh import DATA_AXIS, MODEL_AXIS
from bert4clickpath.training.train_state import TrainState, ema_update
from bert4clickpath.utils.device import compute_dtype


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_vocab_rows(vocab_rows: int, model_shards: int, kernel_tile: int = 1024) -> int:
    """Table rows padded so (a) the row-shard divides evenly over the model
    axis and (b) each shard is a multiple of ``kernel_tile`` rows, which
    the fused CE's tiles and the eval scan's chunks divide (ops/fused_ce.py,
    ops/chunked_eval.py); extra rows are blinded in the projection
    (embedding.sharded_logits_local)."""
    per_shard = round_up(-(-vocab_rows // model_shards), kernel_tile)
    return per_shard * model_shards


def _is_sharded_table(path_keys, config: ModelConfig) -> bool:
    names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path_keys]
    return f"embed_{config.item_feature}" in names and "embedding" in names


def param_specs(params, config: ModelConfig):
    """PartitionSpec tree: item table P(model, None); all else replicated."""

    def spec(path, leaf):
        if _is_sharded_table(path, config):
            return P(MODEL_AXIS, None)
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


def state_specs(state: TrainState, config: ModelConfig):
    """Specs for the full TrainState: opt_state mirrors params (mu/nu shard
    with their rows); scalars replicated."""
    p_spec = param_specs(state.params, config)

    def opt_spec(path, leaf):
        if _is_sharded_table(path, config) and leaf.ndim >= 2:
            return P(MODEL_AXIS, None)
        return P()

    o_spec = jax.tree_util.tree_map_with_path(opt_spec, state.opt_state)
    e_spec = (
        None
        if state.ema_params is None
        else param_specs(state.ema_params, config)
    )
    return TrainState(
        step=P(), params=p_spec, opt_state=o_spec, lr_scale=P(), ema_params=e_spec
    )


def batch_specs(config: ModelConfig):
    return {
        "features": {n: P(DATA_AXIS, None) for n in config.features},
        "head_positions": P(DATA_AXIS, None),
        "labels": P(DATA_AXIS, None),
    }


def shard_state(state: TrainState, mesh: Mesh, config: ModelConfig) -> TrainState:
    specs = state_specs(state, config)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def shard_batch(batch: dict, mesh: Mesh, config: ModelConfig) -> dict:
    specs = batch_specs(config)
    return jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        batch,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def _check_spmd_supported(config: ModelConfig) -> None:
    """The vocab-sharded step requires the tied head (the projection shards
    with the table). Every other model feature — tied transform, tied_bias,
    segment embeddings, segment routing — is wired; MLP-head configs use the
    pure data-parallel tier (make_dp_train_step) instead, matching the
    reference's MirroredStrategy scope (source/main.py:46-57). The full
    contract lives in parallel/support.py (one table for every tier)."""
    from bert4clickpath.parallel.support import validate_tier

    validate_tier("spmd", config.head.kind, qkv_fused=config.qkv_fused)


def _encoder_module(config: ModelConfig, remat: bool = False) -> Encoder:
    return Encoder(
        num_layers=config.num_layers,
        d_model=config.d_model,
        num_heads=config.num_heads,
        ffn_dim=config.ffn_dim,
        dropout_rate=config.dropout_rate,
        dtype=compute_dtype(config),
        remat=remat,
        qkv_fused=config.qkv_fused,
        norm_style=config.norm_style,
    )


def _forward_gathered(
    config: ModelConfig,
    encoder: Encoder,
    facade: ClickstreamModel,
    params: dict,
    features: dict,
    head_positions: jnp.ndarray,
    rng,
    deterministic: bool,
):
    """Shared forward to (transformed) head inputs, inside shard_map.

    Returns (gathered (B, P, d_item), item table shard). The item feature's
    table is row-sharded; any additional features use replicated tables.
    Mirrors ClickstreamModel.gather_head_inputs feature-for-feature: segment
    embeddings, mask/segment routing, and the tied-head transform (applied
    through the facade's own methods so numerics match the single-chip path
    exactly).
    """
    dtype = compute_dtype(config)
    names = list(config.features.keys())
    first_tokens = features[names[0]]
    table_shard = params[f"embed_{config.item_feature}"]["embedding"]
    parts = []
    for n in names:
        if n == config.item_feature:
            e = emb_ops.sharded_embedding_lookup(
                table_shard, features[n], MODEL_AXIS, compute_dtype=dtype
            )
        else:
            e = jnp.take(
                params[f"embed_{n}"]["embedding"].astype(dtype), features[n], axis=0
            )
        parts.append(e)
    x = jnp.concatenate(parts, axis=-1)
    # ×√(embedding width) BEFORE the factorized projection — matches
    # ClickstreamModel.encode (see the scale-placement note there)
    x = x * jnp.sqrt(jnp.asarray(x.shape[-1], dtype))
    if config.encoder_dim and config.encoder_dim != sum(
        fc.embedding_dim for fc in config.features.values()
    ):
        # factorized-input projection: replicated params, pure local math
        x = facade.apply({"params": params}, x, method="apply_input_proj")
    if config.positional == "learned":
        pos = params["positions"]["embedding"]
    else:
        pos = jnp.asarray(sinusoidal_positions(config.max_len, config.d_model))
    x = x + pos[: first_tokens.shape[1]].astype(dtype)[None]
    if config.use_segment_embeddings:
        seg = jnp.clip(segment_ids(first_tokens, SEP_ID), 0, config.max_segments - 1)
        x = x + jnp.take(
            params["segment_embed"]["embedding"].astype(dtype), seg, axis=0
        )
    bias = padding_bias(first_tokens)
    rngs = None if deterministic else {"dropout": rng}
    h = encoder.apply(
        {"params": params["encoder"]}, x, bias, deterministic, rngs=rngs
    )
    if config.routing == "segment":
        start, end = config.segment_bounds
        gathered = h[:, start:end]
    else:
        gathered = jnp.take_along_axis(
            h, head_positions[..., None].astype(jnp.int32), axis=1
        )
    if config.head.kind == "tied_softmax" and (
        config.head.dense_dims
        or config.d_model != config.features[config.item_feature].embedding_dim
    ):
        # BERT-MLM transform + width-matching projection — the facade's own
        # modules run on the replicated transform params (pure local math,
        # so autodiff inside shard_map is safe here)
        gathered = facade.apply(
            {"params": params}, gathered, method="apply_tied_transform"
        )
    return gathered.astype(jnp.float32), table_shard


def stacked_batch_specs(config: ModelConfig):
    """batch_specs with a leading unsharded (K,) scan axis."""
    return jax.tree.map(
        lambda s: P(None, *s), batch_specs(config),
        is_leaf=lambda x: isinstance(x, P),
    )


def _scan_sharded(step, mesh: Mesh, state_specs_fn, config: ModelConfig):
    """scan-inside-shard_map: each device runs K steps over its slice of a
    (K, B, ...) stacked batch (shard with :func:`shard_stacked_batch`) in
    ONE dispatch — per-step collectives run inside the scan body. Shared by
    the SPMD and DP scan variants."""

    def sharded_scan(state, stacked, rng):
        s_specs = state_specs_fn(state)

        def scanned(state, batches, rng):
            def body(carry, b):
                return step(carry, b, rng)

            return jax.lax.scan(body, state, batches)

        return jax.shard_map(
            scanned,
            mesh=mesh,
            in_specs=(s_specs, stacked_batch_specs(config), P()),
            out_specs=(s_specs, P()),
            check_vma=False,
        )(state, stacked, rng)

    return jax.jit(sharded_scan, donate_argnums=(0,))


def _tied_bias_model_space(config: ModelConfig, params) -> jnp.ndarray:
    """The replicated (V_label,) ``tied_out_bias`` on model-space rows.

    (The table itself is row-sharded here; the bias stays replicated and
    each vocab shard slices its rows, so the full-rows spread is correct.)
    """
    from bert4clickpath.models.model import tied_bias_model_space

    return tied_bias_model_space(
        params["tied_out_bias"], config.features[config.item_feature].vocab_rows
    )


def make_spmd_train_step(
    config: ModelConfig,
    mesh: Mesh,
    tx: optax.GradientTransformation,
    schedule: Callable,
    label_vocab_size: int,
    remat: bool = False,
    ema_decay: float = 0.0,
    steps_per_call: int = 1,
    _encoder=None,
    _specs_fn=None,
):
    """Jitted sharded train step: (state, batch, rng) -> (state, loss).

    Requires head kind 'tied_softmax' and a single (item) sharded feature for
    the projection (the flagship large-catalog config). ema_decay > 0
    maintains the EMA shadow (sharded like params). steps_per_call > 1
    returns the scan variant over a (K, B, ...) stacked batch (one dispatch
    per K steps; shard inputs with :func:`shard_stacked_batch`).

    ``_encoder``/``_specs_fn`` are the composition hooks used by
    :mod:`bert4clickpath.parallel.tp_spmd` (tensor-parallel encoder on
    the same mesh): an object with the Encoder's ``.apply`` call signature plus a
    ``TrainState -> spec-tree`` function; the caller validates its own tier.
    """
    if _encoder is None:
        _check_spmd_supported(config)
        encoder = _encoder_module(config, remat)
    else:
        encoder = _encoder
    specs_fn = _specs_fn or (lambda st: state_specs(st, config))
    facade = ClickstreamModel(config)

    def step(state: TrainState, batch, rng):
        rng = jax.random.fold_in(rng, state.step)
        rng = jax.random.fold_in(rng, jax.lax.axis_index(DATA_AXIS))

        def loss_fn(params):
            gathered, table_shard = _forward_gathered(
                config,
                encoder,
                facade,
                params,
                batch["features"],
                batch["head_positions"],
                rng,
                deterministic=False,
            )
            if gathered.shape[-1] != table_shard.shape[-1]:
                raise ValueError(
                    "tied SPMD head requires d_model == item embedding dim"
                )
            # fused vocab-parallel CE with a hand-written VJP — the only
            # grad-safe CE inside shard_map (see parallel/embedding.py);
            # the catalog matmuls run in the compute dtype
            gathered = gathered.astype(compute_dtype(config))
            from bert4clickpath.ops.fused_ce import (
                sharded_fused_softmax_ce,
                sharded_fused_softmax_ce_bias,
            )

            if config.head.tied_bias:
                # replicated (V_label,) bias spread onto model-space rows;
                # the bias VJP psums the full gradient onto every shard
                bias_full = _tied_bias_model_space(config, params)
                return sharded_fused_softmax_ce_bias(
                    gathered,
                    table_shard,
                    bias_full,
                    batch["labels"],
                    NUM_RESERVED_TOKENS,
                    label_vocab_size,
                    MODEL_AXIS,
                    DATA_AXIS,
                )
            return sharded_fused_softmax_ce(
                gathered,
                table_shard,
                batch["labels"],
                NUM_RESERVED_TOKENS,
                label_vocab_size,
                MODEL_AXIS,
                DATA_AXIS,
            )

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        # The loss is already the GLOBAL mean (psum(sum)/psum(count)), so each
        # data shard's grad is only its batch's share of the full gradient —
        # psum (not pmean) reassembles d(global loss)/d(params).
        grads = jax.lax.psum(grads, DATA_AXIS)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        lr = schedule(state.step) * state.lr_scale
        updates = jax.tree.map(lambda u: u * lr, updates)
        params = optax.apply_updates(state.params, updates)
        ema = state.ema_params
        if ema_decay > 0.0:
            if ema is None:
                raise ValueError(
                    "ema_decay > 0 requires TrainState.create(..., ema=True)"
                )
            ema = ema_update(ema, params, state.step, ema_decay)
        new_state = state.replace(
            step=state.step + 1, params=params, opt_state=opt_state, ema_params=ema
        )
        return new_state, loss

    def sharded(state, batch, rng):
        s_specs = specs_fn(state)
        return jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(s_specs, batch_specs(config), P()),
            out_specs=(s_specs, P()),
            check_vma=False,
        )(state, batch, rng)

    if steps_per_call <= 1:
        return jax.jit(sharded, donate_argnums=(0,))
    return _scan_sharded(step, mesh, specs_fn, config)


def make_spmd_eval_step(
    config: ModelConfig,
    mesh: Mesh,
    label_vocab_size: int,
    ks=(5, 10),
    _encoder=None,
    _param_specs_fn=None,
):
    """Jitted sharded eval step: (params, batch) -> stats sums dict.

    ``_encoder``/``_param_specs_fn``: composition hooks for the
    tensor-parallel variant (see :func:`make_spmd_train_step`).
    """
    if _encoder is None:
        _check_spmd_supported(config)
        encoder = _encoder_module(config)
    else:
        encoder = _encoder
    param_specs_fn = _param_specs_fn or (lambda p: param_specs(p, config))
    facade = ClickstreamModel(config)

    def step(params, batch):
        gathered, table_shard = _forward_gathered(
            config,
            encoder,
            facade,
            params,
            batch["features"],
            batch["head_positions"],
            None,
            deterministic=True,
        )
        bias_shard = None
        if config.head.tied_bias:
            bias_full = _tied_bias_model_space(config, params)
            idx = jax.lax.axis_index(MODEL_AXIS)
            v_local = table_shard.shape[0]
            bias_shard = jax.lax.dynamic_slice(
                bias_full, (idx * v_local,), (v_local,)
            )
        # chunked per-shard scan: eval never materializes (B, P, V_local)
        # logits either, so 10M-row shards evaluate fine
        return emb_ops.sharded_chunked_eval_stats(
            gathered,
            table_shard,
            batch["labels"],
            ks=ks,
            model_axis=MODEL_AXIS,
            data_axis=DATA_AXIS,
            row_offset=NUM_RESERVED_TOKENS,
            num_valid=label_vocab_size,
            bias_shard=bias_shard,
        )

    def sharded(params, batch):
        p_specs = param_specs_fn(params)
        return jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(p_specs, batch_specs(config)),
            out_specs=_stats_specs(ks),
            check_vma=False,
        )(params, batch)

    return jax.jit(sharded)


def _stats_specs(ks):
    keys = ["n", "loss_sum"]
    for k in ks:
        keys += [f"recall@{k}_sum", f"ndcg@{k}_sum"]
    return {k: P() for k in keys}


# -- pure data-parallel tier (any head kind) ------------------------------
#
# The reference's only distribution story is MirroredStrategy over the
# MLP-softmax-head model (source/main.py:46-57,262): pure DP, params
# replicated, gradients all-reduced. This is its explicit equivalent — and
# it works for EVERY head kind because nothing shards over the model axis.
#
# Collective discipline: autodiff never sees a psum (shard_map with
# check_vma=False mis-derives collective transposes — see the hand-written
# VJPs in parallel/embedding.py). The loss is computed as LOCAL masked
# sums, differentiated locally, and the psums (loss_sum, count, grads)
# happen outside value_and_grad; the global mean's gradient is then
# psum(d local_sum)/psum(count) by linearity.


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Fully replicate a TrainState over the mesh (the DP placement)."""
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), state
    )


def _dp_sums_from_logits(head_kind, logits, labels, pos_weight):
    """(loss_sum, count, scale) on this shard — no collectives."""
    from bert4clickpath.ops import losses as losses_lib

    if head_kind in ("softmax", "tied_softmax"):
        items = losses_lib.softmax_ce_items(logits, labels)
        weights, scale = None, 1.0
    else:
        items, weights, scale = losses_lib.binary_ce_items(
            logits, labels, pos_weight=pos_weight
        )
    mask = (labels != LABEL_PAD).astype(items.dtype)
    if weights is not None:
        items = items * weights
    return jnp.sum(items * mask), jnp.sum(mask), scale


def _dp_local_sums(model, batch, rng, params, pos_weight):
    """(loss_sum, (count, scale)) on this shard — no collectives."""
    logits = model.apply(
        params,
        batch["features"],
        batch.get("head_positions"),
        deterministic=rng is None,
        rngs=None if rng is None else {"dropout": rng},
    )
    total, count, scale = _dp_sums_from_logits(
        model.config.head.kind, logits, batch["labels"], pos_weight
    )
    return total, (count, scale)


def make_dp_train_step(
    model: ClickstreamModel,
    mesh: Mesh,
    tx: optax.GradientTransformation,
    schedule: Callable,
    pos_weight: Optional[float] = None,
    ema_decay: float = 0.0,
    fused_ce_num_valid: Optional[int] = None,
    steps_per_call: int = 1,
):
    """Jitted data-parallel train step for any head kind.

    steps_per_call > 1 returns a scan variant,
    ``(state, stacked_batches, rng) -> (state, (K,) losses)``: the batch
    pytree carries a leading (K,) axis (shard with
    :func:`shard_stacked_batch`), and each device runs all K steps in one
    dispatch — the DP composition of make_scan_train_step.

    ``(state, batch, rng) -> (state, loss)`` with the same contract as the
    single-chip ``make_train_step``: state holds the FULL variables dict
    (``{'params': ...}``), batch rows shard over the ``data`` axis, params
    replicate. Gradient = psum(local-sum grads) / psum(mask count), exactly
    the single-device global-mean gradient.

    fused_ce_num_valid: softmax-family heads only — route each shard's local
    CE sums through the fused CE (no (B_local, P, V) logits);
    the psum-outside-autodiff reduction is unchanged, so the gradient stays
    exactly the global mean.
    """
    from bert4clickpath.parallel.support import validate_tier

    validate_tier(
        "dp", model.config.head.kind,
        qkv_fused=model.config.qkv_fused,
    )
    if fused_ce_num_valid is not None:
        assert model.config.head.kind in ("tied_softmax", "softmax"), (
            "fused_ce_num_valid requires a softmax-family head"
        )
        from bert4clickpath.training.train_state import fused_head_ce_sums

    def step(state: TrainState, batch, rng):
        rng = jax.random.fold_in(rng, state.step)
        rng = jax.random.fold_in(rng, jax.lax.axis_index(DATA_AXIS))

        def total_fn(params):
            if fused_ce_num_valid is not None:
                total, count = fused_head_ce_sums(
                    model, params, batch, rng, fused_ce_num_valid
                )
                return total, (count, 1.0)
            return _dp_local_sums(model, batch, rng, params, pos_weight)

        (total, (count, scale)), grads = jax.value_and_grad(
            total_fn, has_aux=True
        )(state.params)
        total = jax.lax.psum(total, DATA_AXIS)
        count = jax.lax.psum(count, DATA_AXIS)
        denom = jnp.maximum(count, 1.0) * scale
        loss = total / denom
        grads = jax.lax.psum(grads, DATA_AXIS)
        grads = jax.tree.map(lambda g: g / denom, grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        lr = schedule(state.step) * state.lr_scale
        updates = jax.tree.map(lambda u: u * lr, updates)
        params = optax.apply_updates(state.params, updates)
        ema = state.ema_params
        if ema_decay > 0.0:
            if ema is None:
                raise ValueError(
                    "ema_decay > 0 requires TrainState.create(..., ema=True)"
                )
            ema = ema_update(ema, params, state.step, ema_decay)
        new_state = state.replace(
            step=state.step + 1, params=params, opt_state=opt_state, ema_params=ema
        )
        return new_state, loss

    def sharded(state, batch, rng):
        r_specs = jax.tree.map(lambda _: P(), state)
        return jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(r_specs, batch_specs(model.config), P()),
            out_specs=(r_specs, P()),
            check_vma=False,
        )(state, batch, rng)

    if steps_per_call <= 1:
        return jax.jit(sharded, donate_argnums=(0,))
    return _scan_sharded(
        step, mesh, lambda st: jax.tree.map(lambda _: P(), st), model.config
    )


def shard_stacked_batch(batch: dict, mesh: Mesh, config: ModelConfig) -> dict:
    """Place a (K, B, ...) stacked batch with rows sharded over 'data'."""
    return jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        batch,
        stacked_batch_specs(config),
    )


def make_dp_eval_step(
    model: ClickstreamModel,
    mesh: Mesh,
    ks=(5, 10),
    pos_weight: Optional[float] = None,
    chunked_num_valid: Optional[int] = None,
):
    """Jitted data-parallel eval step: (params, batch) -> global stat sums.

    Same stats contract as the single-chip ``make_eval_step`` (sums + n, so
    the trainer's cross-batch aggregation is exact); psums run outside any
    autodiff, so plain collectives are safe here.

    chunked_num_valid: softmax-family heads — each shard ranks its batch
    rows via the chunked catalog scan (ops/chunked_eval) instead of dense
    (B_local, P, V) logits, then the stat sums psum. Required at large
    catalogs (dense eval logits at 10M items would be GBs per device).
    """
    from bert4clickpath.ops import metrics as metrics_lib

    head_kind = model.config.head.kind
    use_chunked = chunked_num_valid is not None and head_kind in (
        "tied_softmax",
        "softmax",
    )
    if use_chunked:
        from bert4clickpath.models.model import head_catalog
        from bert4clickpath.ops.chunked_eval import (
            chunked_eval_stats,
            pick_chunk,
        )

    def step(params, batch):
        if use_chunked:
            gathered = model.apply(
                params,
                batch["features"],
                batch.get("head_positions"),
                deterministic=True,
                method=(
                    "gather_head_inputs"
                    if head_kind == "tied_softmax"
                    else "head_trunk_outputs"
                ),
            )
            table, bias, row_offset, _ = head_catalog(model.config, params)
            local = chunked_eval_stats(
                gathered,
                table,
                batch["labels"],
                ks=ks,
                row_offset=row_offset,
                num_valid=chunked_num_valid,
                chunk=pick_chunk(
                    table.shape[0],
                    rows=gathered.shape[0] * gathered.shape[1],
                ),
                bias=bias,
            )
            return metrics_lib.psum_stats(local, DATA_AXIS)
        logits = model.apply(
            params,
            batch["features"],
            batch.get("head_positions"),
            deterministic=True,
        )
        labels = batch["labels"]
        total, count, scale = _dp_sums_from_logits(
            head_kind, logits, labels, pos_weight
        )
        stats = {
            "loss_sum": jax.lax.psum(total / scale, DATA_AXIS),
            "n": jax.lax.psum(count, DATA_AXIS),
        }
        if head_kind in ("softmax", "tied_softmax"):
            rstats = metrics_lib.ranking_stats(logits, labels, ks=ks)
            rstats = metrics_lib.psum_stats(rstats, DATA_AXIS)
            rstats.pop("n")
            stats.update(rstats)
        elif head_kind == "binary":
            bstats = metrics_lib.binary_stats(logits, labels)
            bstats = metrics_lib.psum_stats(bstats, DATA_AXIS)
            bstats.pop("n")
            stats.update(bstats)
        return stats

    def out_specs():
        keys = ["loss_sum", "n"]
        if head_kind in ("softmax", "tied_softmax"):
            for k in ks:
                keys += [f"recall@{k}_sum", f"ndcg@{k}_sum"]
        elif head_kind == "binary":
            keys += ["positives_sum", "pred_positives_sum", "tp_sum"]
        return {k: P() for k in keys}

    def sharded(params, batch):
        p_specs = jax.tree.map(lambda _: P(), params)
        return jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(p_specs, batch_specs(model.config)),
            out_specs=out_specs(),
            check_vma=False,
        )(params, batch)

    return jax.jit(sharded)


def make_sampled_spmd_train_step(
    model: ClickstreamModel,
    mesh: Mesh,
    tx: optax.GradientTransformation,
    schedule: Callable,
    num_valid: int,
    num_samples: int,
    ema_decay: float = 0.0,
    donate: bool = True,
):
    """Sampled-softmax training over the row-sharded table via pjit
    auto-sharding.

    The sampled loss (ops/losses.py:sampled_softmax_ce) touches only S+N
    table rows per step, so the hand-written shard_map collectives of the
    fused-CE tier buy nothing here — annotate the same shardings (table +
    Adam moments P('model', None), batch P('data')) on the standard
    single-program step and let the partitioner turn the two row-gathers
    into collectives; the scatter-add gradient lands on the owning shards.
    The very-large-catalog composition: table/optimizer memory scales down
    with the model axis while the per-step loss stays O(N·S·D).
    """
    from bert4clickpath.parallel.support import validate_tier
    from bert4clickpath.training.train_state import make_train_step

    validate_tier(
        "sampled_spmd",
        model.config.head.kind,
        qkv_fused=model.config.qkv_fused,
        sampled=num_samples,
    )

    step = make_train_step(
        model,
        tx,
        schedule,
        raw=True,
        fused_ce_num_valid=num_valid,
        sampled_softmax_samples=num_samples,
        ema_decay=ema_decay,
    )
    cache = {}

    def jitted(state: TrainState, batch, rng):
        if "fn" not in cache:
            sspec = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                state_specs(state, model.config),
                is_leaf=lambda x: isinstance(x, P),
            )
            bspec = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                batch_specs(model.config),
                is_leaf=lambda x: isinstance(x, P),
            )
            cache["fn"] = jax.jit(
                step,
                in_shardings=(sspec, bspec, NamedSharding(mesh, P())),
                out_shardings=(sspec, NamedSharding(mesh, P())),
                donate_argnums=(0,) if donate else (),
            )
        return cache["fn"](state, batch, rng)

    return jitted

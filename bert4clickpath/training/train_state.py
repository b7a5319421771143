"""Train state + jitted step factories.

The functional replacement for Keras ``model.compile``/``fit``'s train step
(reference source/main.py:60-97,159-165): Adam(b1=0.9, b2=0.999, eps=1e-9)
with the loss chosen by head kind, all inside one jitted function.

LR plumbing: updates are produced by ``scale_by_adam`` and multiplied by
``schedule(step) * lr_scale`` inside the step; ``lr_scale`` is a state field
the trainer shrinks on validation plateau (reference ReduceLROnPlateau,
source/main.py:134) — no retrace, works under pjit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

from bert4clickpath.constants import LABEL_PAD
from bert4clickpath.models.model import head_catalog
from bert4clickpath.utils.device import compute_dtype
from bert4clickpath.ops import metrics as metrics_lib
from bert4clickpath.ops.losses import (
    masked_binary_cross_entropy,
    masked_multilabel_cross_entropy,
    masked_softmax_cross_entropy,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any
    lr_scale: jnp.ndarray  # plateau-decayed multiplier
    ema_params: Any = None  # EMA shadow of params (None when disabled)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(cls, params, tx, ema: bool = False):
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
            lr_scale=jnp.ones((), jnp.float32),
            ema_params=jax.tree.map(jnp.copy, params) if ema else None,
        )


def eval_params(state: TrainState):
    """Parameters to evaluate/export with: the EMA shadow when enabled."""
    return state.params if state.ema_params is None else state.ema_params


def ema_update(ema_params, params, step, decay: float):
    """Ramped EMA: decay_t = min(decay, (1+t)/(10+t)).

    The ramp (TF ExponentialMovingAverage's num_updates form) makes early
    averages track params closely instead of the init point, so no debias
    state is needed.
    """
    d = jnp.minimum(decay, (1.0 + step) / (10.0 + step)).astype(jnp.float32)
    return jax.tree.map(
        lambda e, p: (d * e + (1.0 - d) * p.astype(e.dtype)), ema_params, params
    )


def make_optimizer(
    cfg, mu_dtype=None, weight_decay: float = 0.0, decay_tables: bool = False
) -> optax.GradientTransformation:
    """Adam sans-LR; LR applied in the step (see module docstring).

    mu_dtype=jnp.bfloat16 halves the first-moment memory — worthwhile when a
    sharded embedding table's Adam state dominates HBM (10M-item configs).

    weight_decay > 0 gives AdamW-style decoupled decay on matrix params
    (kernels; embedding tables, biases, and LayerNorm scales excluded) —
    decay multiplies the same LR as the update since it sits before the
    step's lr scaling.

    decay_tables=True extends the decay to embedding tables (and learned
    positions). With a tied_softmax head the item table IS the output
    layer and holds most of the parameters, so it is the main memorization
    surface — on small corpora (Beauty: 354k interactions under an 18M-param
    flagship) leaving it undecayed lets val ranking collapse while kernels
    stay regularized.
    """
    steps = [
        optax.scale_by_adam(
            b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps, mu_dtype=mu_dtype
        )
    ]
    if weight_decay:

        def decay_mask(params):
            def mask(path, leaf):
                names = [getattr(k, "key", getattr(k, "name", "")) for k in path]
                is_table = any(str(n).startswith("embed_") for n in names) or (
                    "positions" in [str(n) for n in names]
                )
                return leaf.ndim >= 2 and (decay_tables or not is_table)

            return jax.tree_util.tree_map_with_path(mask, params)

        steps.append(optax.add_decayed_weights(weight_decay, mask=decay_mask))
    steps.append(optax.scale(-1.0))
    return optax.chain(*steps)


def fused_head_ce_sums(model, params, batch, rng, num_valid: int):
    """(nll_sum, mask_count) through the fused CE — no (B, P, V) logits, no
    collectives. The catalog matmuls run in the model's compute dtype.

    Covers both softmax-family heads: ``tied_softmax`` projects onto the
    item table (+ optional ``tied_bias`` spread onto model-space rows);
    ``softmax`` (the reference parity MLP head) streams its final
    ``Dense(V)`` kernel+bias through the kernel with rows padded to a vocab
    tile and blinded. The sums form is the data-parallel building block —
    reduce OUTSIDE autodiff (parallel/spmd.make_dp_train_step pattern).
    """
    from bert4clickpath.ops.fused_ce import fused_masked_ce_sums

    head_kind = model.config.head.kind
    if head_kind not in ("tied_softmax", "softmax"):
        raise ValueError(f"fused CE requires a softmax-family head, got {head_kind}")
    gathered = model.apply(
        params,
        batch["features"],
        batch.get("head_positions"),
        deterministic=rng is None,
        rngs=None if rng is None else {"dropout": rng},
        method=(
            "gather_head_inputs"
            if head_kind == "tied_softmax"
            else "head_trunk_outputs"
        ),
    )
    table, bias, row_offset, _ = head_catalog(model.config, params)
    return fused_masked_ce_sums(
        gathered.astype(compute_dtype(model.config)), table, batch["labels"],
        row_offset, num_valid, bias=bias,
    )


def sampled_head_ce_sums(
    model, params, batch, rng, sample_rng, num_valid: int, num_samples: int
):
    """(nll_sum, mask_count) through sampled softmax (ops/losses.py) —
    O(N·S·D) instead of O(N·V·D): the large-catalog training escape hatch.
    Same head coverage and sums contract as :func:`fused_head_ce_sums`;
    eval stays exact (chunked catalog scan)."""
    from bert4clickpath.ops.losses import sampled_softmax_ce

    head_kind = model.config.head.kind
    if head_kind not in ("tied_softmax", "softmax"):
        raise ValueError(
            f"sampled softmax requires a softmax-family head, got {head_kind}"
        )
    gathered = model.apply(
        params,
        batch["features"],
        batch.get("head_positions"),
        deterministic=rng is None,
        rngs=None if rng is None else {"dropout": rng},
        method=(
            "gather_head_inputs"
            if head_kind == "tied_softmax"
            else "head_trunk_outputs"
        ),
    )
    table, bias, row_offset, _ = head_catalog(model.config, params)
    labels = batch["labels"].reshape(-1)
    x = gathered.reshape(-1, gathered.shape[-1])
    nll = sampled_softmax_ce(
        x, table, labels, row_offset, num_valid, num_samples, sample_rng,
        bias=None if bias is None else bias.reshape(-1),
    )
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    return jnp.sum(nll), jnp.sum(mask)


def loss_for_head(head_kind: str) -> Callable:
    if head_kind in ("softmax", "tied_softmax"):
        return masked_softmax_cross_entropy
    if head_kind == "binary":
        return masked_binary_cross_entropy
    if head_kind == "multilabel":
        return masked_multilabel_cross_entropy
    raise ValueError(head_kind)


def make_train_step(
    model,
    tx: optax.GradientTransformation,
    schedule: Callable,
    loss_fn: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    donate: bool = True,
    fused_ce_num_valid: Optional[int] = None,
    ema_decay: float = 0.0,
    raw: bool = False,
    sampled_softmax_samples: Optional[int] = None,
):
    """Returns jitted ``(state, batch, rng) -> (state, loss)``.

    raw=True returns the step UN-jitted so a caller can jit it with its own
    sharding annotations (parallel/tp.py wraps it in a tensor-parallel jit).

    ema_decay > 0 maintains an EMA shadow of the params (state.ema_params,
    created via ``TrainState.create(..., ema=True)``); evaluation/export
    should read ``eval_params(state)``.

    batch: {'features': {...}, 'head_positions': (B,P), 'labels': (B,P)}.
    Under pjit, pass ``axis_name='data'`` so loss normalization psums.

    fused_ce_num_valid: for softmax-family heads, route the loss through the
    fused tied-projection CE (ops/fused_ce.py) instead of dense logits;
    pass the raw label vocabulary size V.

    sampled_softmax_samples: with fused_ce_num_valid (supplying V), train on
    S batch-shared uniform negatives instead of the full catalog —
    O(N·S·D) loss at very large V (ops/losses.py:sampled_softmax_ce); eval
    stays exact. The loss VALUE is a stochastic estimate of the full CE.
    """
    head_kind = model.config.head.kind
    loss_fn = loss_fn or loss_for_head(head_kind)
    use_fused = fused_ce_num_valid is not None and head_kind in (
        "tied_softmax",
        "softmax",
    )
    if sampled_softmax_samples is not None:
        if not use_fused:
            raise ValueError(
                "sampled_softmax_samples requires fused_ce_num_valid (it "
                "supplies the valid-row count) and a softmax-family head"
            )
        if sampled_softmax_samples <= 0:
            raise ValueError("sampled_softmax_samples must be positive")
    if use_fused and axis_name is not None:
        raise ValueError(
            "fused_ce_num_valid computes a locally-normalized masked mean; "
            "psum-ing its grads under axis_name would sum per-shard means "
            "(wrong when shard mask counts differ). Use "
            "parallel.spmd.make_spmd_train_step for the sharded fused path."
        )
    def step(state: TrainState, batch, rng):
        rng = jax.random.fold_in(rng, state.step)

        def compute_loss(params):
            if use_fused and sampled_softmax_samples is not None:
                total, count = sampled_head_ce_sums(
                    model, params, batch, rng,
                    jax.random.fold_in(rng, 1),  # negatives stream
                    fused_ce_num_valid, sampled_softmax_samples,
                )
                return total / jnp.maximum(count, 1.0)
            if use_fused:
                total, count = fused_head_ce_sums(
                    model, params, batch, rng, fused_ce_num_valid
                )
                return total / jnp.maximum(count, 1.0)
            logits = model.apply(
                params,
                batch["features"],
                batch.get("head_positions"),
                deterministic=False,
                rngs={"dropout": rng},
            )
            return loss_fn(logits, batch["labels"], axis_name=axis_name)

        loss, grads = jax.value_and_grad(compute_loss)(state.params)
        if axis_name is not None:
            # losses normalize globally (psum sums/counts) when axis_name is
            # set, so per-shard grads are partial — psum, not pmean
            grads = jax.lax.psum(grads, axis_name)
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

    if raw:
        return step
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_scan_train_step(
    model,
    tx: optax.GradientTransformation,
    schedule: Callable,
    **kwargs,
):
    """Returns jitted ``(state, stacked_batches, rng) -> (state, losses)``.

    Runs K train steps in ONE device program via ``lax.scan`` over a
    batch pytree whose leaves carry a leading (K, ...) axis. The math is
    identical to K calls of :func:`make_train_step` (the same raw step is
    the scan body; per-step RNG still folds in ``state.step``) — what
    changes is the host interaction: one dispatch and one host→device
    transfer per K steps instead of per step, so the host's per-step
    dispatch cost is paid once per K. The scan body compiles once
    regardless of K.

    kwargs forward to make_train_step (loss_fn, fused_ce_num_valid,
    ema_decay, ...). losses come back as a (K,) device array.
    """
    donate = kwargs.pop("donate", True)
    step = make_train_step(model, tx, schedule, raw=True, **kwargs)

    def multi(state: TrainState, stacked_batches, rng):
        def body(carry, batch):
            new_state, loss = step(carry, batch, rng)
            return new_state, loss

        return jax.lax.scan(body, state, stacked_batches)

    return jax.jit(multi, donate_argnums=(0,) if donate else ())


def make_eval_step(
    model,
    loss_fn: Optional[Callable] = None,
    ks=(5, 10),
    axis_name: Optional[str] = None,
    chunked_num_valid: Optional[int] = None,
    raw: bool = False,
    steps_per_call: int = 1,
):
    """Returns jitted ``(params, batch) -> (loss_sum_stats, metric_stats)``.

    Emits *sums* so the host (or a psum) can aggregate exactly across
    batches/devices; ranking metrics only for softmax-family heads.

    chunked_num_valid: for tied_softmax heads, evaluate via the chunked
    full-catalog scan (ops/chunked_eval.py) instead of dense logits — pass
    the raw label vocab size V. Required at very large catalogs; also
    avoids the (B, P, V) f32 eval tensor at Beauty scale.

    steps_per_call > 1: the step takes a STACKED (K, B, ...) batch,
    lax.scans the per-batch step over the leading axis and returns the
    summed stats — one dispatch (and one transfer) per K eval batches, the
    same dispatch-amortization lever as make_scan_train_step. Stats are sums, so
    the result is identical to K separate calls merged on device.
    """
    head_kind = model.config.head.kind
    loss_fn = loss_fn or loss_for_head(head_kind)

    if chunked_num_valid is not None and head_kind in ("tied_softmax", "softmax"):
        from bert4clickpath.ops.chunked_eval import (
            chunked_eval_stats,
            pick_chunk,
        )

        def chunked_step(params, batch):
            # tied: rank against the shared embedding table; MLP softmax:
            # scan the final Dense(V) rows — either way the dense eval
            # path's (B, P, V) f32 logits (1.8 GB at Beauty scale with
            # eval_batch=512) never materialize
            gather_method = (
                "gather_head_inputs"
                if head_kind == "tied_softmax"
                else "head_trunk_outputs"
            )
            gathered = model.apply(
                params,
                batch["features"],
                batch.get("head_positions"),
                deterministic=True,
                method=gather_method,
            )
            table, bias, row_offset, _ = head_catalog(model.config, params)
            return chunked_eval_stats(
                gathered,
                table,
                batch["labels"],
                ks=ks,
                row_offset=row_offset,
                num_valid=chunked_num_valid,
                # rows bounds the (B*P, chunk) f32 logits tile the scan holds
                chunk=pick_chunk(
                    table.shape[0],
                    rows=gathered.shape[0] * gathered.shape[1],
                ),
                bias=bias,
            )

        return _wrap_eval(chunked_step, steps_per_call, raw)

    def step(params, batch):
        logits = model.apply(
            params, batch["features"], batch.get("head_positions"), deterministic=True
        )
        labels = batch["labels"]
        loss = loss_fn(logits, labels, axis_name=axis_name)
        mask = (labels != -1).astype(jnp.float32)
        n = jnp.sum(mask)
        if axis_name is not None:
            n = jax.lax.psum(n, axis_name)
        stats = {"loss_sum": loss * n, "n": n}
        if head_kind in ("softmax", "tied_softmax"):
            rstats = metrics_lib.ranking_stats(logits, labels, ks=ks)
            if axis_name is not None:
                rstats = metrics_lib.psum_stats(rstats, axis_name)
            rstats.pop("n")
            stats.update(rstats)
        elif head_kind in ("binary", "multilabel"):
            # binary_stats is elementwise, so it applies to (B, C) multi-hot
            # labels unchanged (per-class counts pooled)
            bstats = metrics_lib.binary_stats(logits, labels)
            if axis_name is not None:
                bstats = metrics_lib.psum_stats(bstats, axis_name)
            bstats.pop("n")
            stats.update(bstats)
        return stats

    return _wrap_eval(step, steps_per_call, raw)


def _wrap_eval(step, steps_per_call: int, raw: bool):
    """Optionally scan ``step`` over a stacked (K, B, ...) batch, summing
    the per-batch stat sums on device; then jit unless ``raw``."""
    fn = step
    if steps_per_call > 1:

        def scan_eval(params, stacked):
            def body(carry, b):
                return carry, step(params, b)

            _, stats = jax.lax.scan(body, None, stacked)
            return jax.tree.map(lambda x: jnp.sum(x, axis=0), stats)

        fn = scan_eval
    return fn if raw else jax.jit(fn)

"""Row-sharded embedding tables: lookup, vocab-parallel CE, distributed top-k.

The core of the large-catalog tier (BASELINE.json north star; nothing like it
exists in the reference, which used a single-device Keras Embedding,
transformer.py:346-355). The item table lives row-sharded across the
``model`` mesh axis; these functions run *inside* ``jax.shard_map`` where
each device holds its ``(V_local, D)`` shard:

* :func:`sharded_embedding_lookup` — each shard gathers the rows it owns and
  a ``psum`` over ``model`` assembles full embeddings, with a hand-written
  VJP (per-shard scatter-add).

  Comm-pattern note: the north star sketches an all-to-all exchange. With
  this framework's layout the consumer (the encoder) runs replicated across
  the ``model`` axis, so every model shard needs every looked-up row —
  an allreduce (psum) of masked gathers IS the minimal collective; an
  all-to-all would only win if activations were also model-sharded (tensor
  parallelism), which a 2-4 layer encoder doesn't warrant (SURVEY.md §2.2
  marks TP optional). The psum rides the same links the all-to-all
  would.
* :func:`sharded_softmax_cross_entropy` — Megatron-style vocab-parallel CE:
  local partial logits ``x @ shard^T``, global logsumexp via
  pmax/psum, label logit fetched from the owning shard. The full
  ``(B, P, V)`` logits tensor is **never materialized in HBM** — at 10M items
  that tensor would be ~4 GB per batch; here peak extra memory is
  ``(B, P, V/S)``.
* :func:`sharded_top_k` — local top-k per shard, all_gather of S*k
  candidates, exact global top-k merge (eval at full catalog).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from bert4clickpath.constants import LABEL_PAD


def shard_info(axis_name: str) -> tuple[jnp.ndarray, int]:
    """(my shard index, number of shards) inside shard_map."""
    return jax.lax.axis_index(axis_name), jax.lax.axis_size(axis_name)


import functools


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def sharded_embedding_lookup(
    table_shard: jnp.ndarray,  # (V_local, D) this device's rows
    ids: jnp.ndarray,  # (...,) global row ids
    axis_name: str = "model",
    compute_dtype=None,
) -> jnp.ndarray:
    """Gather global ids from a row-sharded table; returns (..., D) full
    embeddings on every shard.

    custom_vjp: autodiffing through ``psum`` inside shard_map (check_vma off)
    mis-transposes collectives — the backward here is written by hand: the
    output cotangent is replicated across model shards, and each shard
    scatter-adds exactly the rows it owns.
    """
    return _lookup_fwd_impl(table_shard, ids, axis_name, compute_dtype)


def _lookup_fwd_impl(table_shard, ids, axis_name, compute_dtype):
    idx, _ = shard_info(axis_name)
    v_local = table_shard.shape[0]
    local = ids - idx * v_local
    in_range = (local >= 0) & (local < v_local)
    rows = jnp.take(table_shard, jnp.clip(local, 0, v_local - 1), axis=0)
    if compute_dtype is not None:
        rows = rows.astype(compute_dtype)
    rows = jnp.where(in_range[..., None], rows, jnp.zeros_like(rows))
    return jax.lax.psum(rows, axis_name)


def _lookup_fwd(table_shard, ids, axis_name, compute_dtype):
    out = _lookup_fwd_impl(table_shard, ids, axis_name, compute_dtype)
    # zero-size carrier for the shard's static shape/dtype (residuals must be
    # JAX types; referencing the live table would also work but this is free)
    shard_aval = jnp.zeros((table_shard.shape[0], 0), table_shard.dtype)
    return out, (shard_aval, ids)


def _lookup_bwd(axis_name, compute_dtype, res, g):
    shard_aval, ids = res
    v_local, dtype = shard_aval.shape[0], shard_aval.dtype
    idx, _ = shard_info(axis_name)
    local = ids - idx * v_local
    in_range = (local >= 0) & (local < v_local)
    g = jnp.where(in_range[..., None], g, jnp.zeros_like(g))
    flat_ids = jnp.clip(local, 0, v_local - 1).reshape(-1)
    flat_g = g.reshape(-1, g.shape[-1]).astype(dtype)
    d_table = jnp.zeros((v_local, g.shape[-1]), dtype).at[flat_ids].add(flat_g)
    return d_table, None


sharded_embedding_lookup.defvjp(_lookup_fwd, _lookup_bwd)


NEG_BIG = -1e30  # blinds reserved/OOV/padding rows in f32 logits


def sharded_logits_local(
    x: jnp.ndarray,  # (B, P, D)
    table_shard: jnp.ndarray,  # (V_local, D) rows this shard owns
    shard_index: Optional[jnp.ndarray] = None,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
) -> jnp.ndarray:
    """Partial tied-projection logits over this shard's vocab rows (f32).

    With tied weights the shard holds *model-space* rows (reserved tokens,
    raw vocab, OOV bucket, divisibility padding). ``row_offset`` /
    ``num_valid`` blind every row outside ``[row_offset, row_offset +
    num_valid)`` so reserved/OOV/pad rows can never be predicted — the
    model-space CE then equals CE over the raw label space.
    """
    logits = jnp.einsum(
        "bpd,vd->bpv", x, table_shard.astype(x.dtype), preferred_element_type=jnp.float32
    )
    if num_valid is not None:
        assert shard_index is not None
        v_local = table_shard.shape[0]
        rows = shard_index * v_local + jnp.arange(v_local)
        valid = (rows >= row_offset) & (rows < row_offset + num_valid)
        logits = jnp.where(valid[None, None, :], logits, NEG_BIG)
    return logits


def sharded_softmax_cross_entropy(
    x: jnp.ndarray,  # (B, P, D) gathered head inputs
    table_shard: jnp.ndarray,  # (V_local, D) projection rows this shard owns
    labels: jnp.ndarray,  # (B, P) label-space ids, LABEL_PAD padded
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
    label_pad: int = LABEL_PAD,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
) -> jnp.ndarray:
    """Globally-normalized masked CE without materializing full logits.

    ``row_offset``/``num_valid`` handle the tied model-space table (see
    :func:`sharded_logits_local`); labels stay in label space and are shifted
    by ``row_offset`` when locating their owning shard.

    **Forward value only** (eval). Do NOT differentiate through this inside
    shard_map: with replication checking off, autodiff mis-transposes
    psum/pmax. The training path is
    ``ops.fused_ce.sharded_fused_softmax_ce`` (hand-written VJP).
    """
    idx, _ = shard_info(model_axis)
    v_local = table_shard.shape[0]
    logits_local = sharded_logits_local(
        x, table_shard, idx, row_offset, num_valid
    )  # (B, P, Vl) f32

    # The max shift is for numerical stability only — mathematically it
    # cancels in logz, so cut it out of the autodiff graph (pmax has no VJP).
    local_max = jax.lax.stop_gradient(jnp.max(logits_local, axis=-1))
    global_max = jax.lax.pmax(local_max, model_axis)  # (B, P)
    # NEG_BIG rows underflow to exp(-huge)=0 — they never enter the partition
    sumexp = jnp.sum(jnp.exp(logits_local - global_max[..., None]), axis=-1)
    total = jax.lax.psum(sumexp, model_axis)
    logz = global_max + jnp.log(total)  # (B, P)

    safe = jnp.where(labels == label_pad, 0, labels) + row_offset
    local_label = safe - idx * v_local
    owned = (local_label >= 0) & (local_label < v_local)
    picked = jnp.take_along_axis(
        logits_local, jnp.clip(local_label, 0, v_local - 1)[..., None], axis=-1
    )[..., 0]
    label_logit = jax.lax.psum(jnp.where(owned, picked, 0.0), model_axis)

    nll = logz - label_logit
    mask = (labels != label_pad).astype(nll.dtype)
    total_loss = jnp.sum(nll * mask)
    count = jnp.sum(mask)
    if data_axis is not None:
        total_loss = jax.lax.psum(total_loss, data_axis)
        count = jax.lax.psum(count, data_axis)
    return total_loss / jnp.maximum(count, 1.0)


def sharded_top_k(
    logits_local: jnp.ndarray,  # (..., V_local)
    k: int,
    model_axis: str = "model",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact global top-k over the sharded vocab dimension.

    Returns (values, global indices), both (..., k), identical on every
    model shard. Communication: one all_gather of k candidates per shard —
    S*k values instead of the full V.
    """
    idx, _ = shard_info(model_axis)
    v_local = logits_local.shape[-1]
    kk = min(k, v_local)
    vals, local_idx = jax.lax.top_k(logits_local, kk)
    global_idx = local_idx + idx * v_local
    # (S, ..., kk) on every shard
    all_vals = jax.lax.all_gather(vals, model_axis)
    all_idx = jax.lax.all_gather(global_idx, model_axis)
    # fold shard axis into candidates: (..., S*kk)
    all_vals = jnp.moveaxis(all_vals, 0, -2).reshape(*vals.shape[:-1], -1)
    all_idx = jnp.moveaxis(all_idx, 0, -2).reshape(*vals.shape[:-1], -1)
    top_vals, pos = jax.lax.top_k(all_vals, k)
    top_idx = jnp.take_along_axis(all_idx, pos, axis=-1)
    return top_vals, top_idx


def _eval_chunk(v_local: int, rows: int = 0) -> int:
    from bert4clickpath.ops.chunked_eval import pick_chunk

    return pick_chunk(v_local, rows=rows)


def sharded_chunked_eval_stats(
    x: jnp.ndarray,  # (B, P, D)
    table_shard: jnp.ndarray,  # (V_local, D)
    labels: jnp.ndarray,  # (B, P) label-space
    ks=(5, 10),
    model_axis: str = "model",
    data_axis: Optional[str] = "data",
    label_pad: int = LABEL_PAD,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
    bias_shard: Optional[jnp.ndarray] = None,  # (V_local,) per-row logit bias
) -> dict[str, jnp.ndarray]:
    """Full-catalog eval stats with per-shard *chunked* scanning.

    The ONLY exported sharded eval path: each shard streams its rows in
    chunks (ops/chunked_eval.py) so nothing ever materializes a (B, P,
    V_local) tile — eval works at 10M rows/shard. Cross-shard combine:
    global logsumexp over shard-local logz, psum label logit, all_gather
    top-k candidates. ``bias_shard`` adds this shard's slice of a per-row
    logit bias (tied_bias heads).
    """
    from bert4clickpath.ops.chunked_eval import chunked_scores

    idx, _ = shard_info(model_axis)
    v_local = table_shard.shape[0]
    kmax = max(ks)
    logz_l, label_logit_l, vals_l, rows_l = chunked_scores(
        x,
        table_shard,
        labels,
        kmax,
        row_offset=row_offset,
        num_valid=num_valid,
        chunk=_eval_chunk(v_local, rows=x.shape[0] * x.shape[1]),
        base_row=idx * v_local,
        bias=bias_shard,
    )
    # global logsumexp from shard-local logz
    gmax = jax.lax.pmax(logz_l, model_axis)
    total = jax.lax.psum(jnp.exp(logz_l - gmax), model_axis)
    logz = gmax + jnp.log(total)
    label_logit = jax.lax.psum(label_logit_l, model_axis)
    # global top-k from per-shard candidates
    all_vals = jax.lax.all_gather(vals_l, model_axis)  # (S, B, P, k)
    all_rows = jax.lax.all_gather(rows_l, model_axis)
    all_vals = jnp.moveaxis(all_vals, 0, -2).reshape(*vals_l.shape[:-1], -1)
    all_rows = jnp.moveaxis(all_rows, 0, -2).reshape(*vals_l.shape[:-1], -1)
    top_vals, sel = jax.lax.top_k(all_vals, kmax)
    top_rows = jnp.take_along_axis(all_rows, sel, axis=-1)

    from bert4clickpath.ops.chunked_eval import ranking_sums_from_topk

    stats = ranking_sums_from_topk(
        logz, label_logit, top_rows - row_offset, labels, ks, label_pad
    )
    if data_axis is not None:
        stats = {k: jax.lax.psum(v, data_axis) for k, v in stats.items()}
    return stats

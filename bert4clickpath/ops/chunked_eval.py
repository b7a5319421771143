"""Full-catalog eval without materializing logits: chunked scan + top-k merge.

Eval needs two things over the whole catalog — a masked CE value and
recall@k/NDCG@k from the top-k — both of which the training path gets from
the fused CE. For eval, an ``lax.scan`` over vocab chunks is enough
(no backward): per chunk the tied projection computes (B, P, C) logits,
folds them into a running (max, sumexp, label-logit, top-k) carry, and
discards them. Peak memory is O(B*P*C) instead of O(B*P*V) — at 10M items
with C=8192 that's 84 MB instead of 102 GB.

Used by the sharded eval step per shard (each shard scans its rows, then
cross-shard psums/all_gathers merge, parallel/embedding.py) and by the
single-chip eval at large V.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from bert4clickpath.constants import LABEL_PAD

NEG_BIG = -1e30


def pick_chunk(v: int, target: int = 0, rows: int = 0) -> int:
    """Largest chunk <= target dividing v; raises rather than falling back to
    a full-table chunk (which would materialize the logits the chunked path
    exists to avoid). Default target scales with the table: chunk count is
    sequential scan steps, so huge catalogs want big chunks (65536 at >1M
    rows — fused_ce.padded_rows aligns such tables to 65536 for exactly
    this).

    ``rows``: the scoring row count (B*P) when known. The scan body holds an
    (rows, chunk) f32 logits tile, so big chunks are only safe when rows is
    small (serving's P=1); a 512x25-row training eval at chunk 65536 would
    be a 3.4 GB tile. The target halves until that tile stays <=256 MB.
    """
    if not target:
        target = 65536 if v > 1_000_000 else 8192
    if rows:
        while target > 128 and rows * target * 4 > (256 << 20):
            target //= 2
    for c in (target, 32768, 16384, 8192, 4096, 2048, 1024, 512, 256, 128):
        if c <= target and v % c == 0:
            return c
    if v <= 8192:
        return v
    raise ValueError(
        f"table rows {v} not divisible by any eval chunk; pad rows "
        "(parallel.spmd.padded_vocab_rows)"
    )


def ranking_sums_from_topk(
    logz: jnp.ndarray,  # (B, P)
    label_logit: jnp.ndarray,  # (B, P)
    top_labels: jnp.ndarray,  # (B, P, kmax) label-space ids
    labels: jnp.ndarray,  # (B, P)
    ks: Sequence[int],
    label_pad: int = LABEL_PAD,
) -> dict[str, jnp.ndarray]:
    """Shared loss/recall/NDCG sums given top-k results (single source of
    truth for the metric arithmetic across the chunked/sharded eval paths)."""
    kmax = max(ks)
    mask = (labels != label_pad).astype(jnp.float32)
    nll = (logz - label_logit) * mask
    hit = (top_labels == labels[..., None]).astype(jnp.float32)
    discounts = 1.0 / (
        jnp.log(jnp.arange(2, kmax + 2, dtype=jnp.float32)) / jnp.log(2.0)
    )
    stats = {"n": jnp.sum(mask), "loss_sum": jnp.sum(nll)}
    for k in ks:
        stats[f"recall@{k}_sum"] = jnp.sum(jnp.sum(hit[..., :k], axis=-1) * mask)
        stats[f"ndcg@{k}_sum"] = jnp.sum(
            jnp.sum(hit[..., :k] * discounts[:k], axis=-1) * mask
        )
    return stats


def chunked_scores(
    x: jnp.ndarray,  # (B, P, D) head inputs
    table: jnp.ndarray,  # (V, D) projection rows (model space)
    labels: jnp.ndarray,  # (B, P) label-space ids, LABEL_PAD padded
    k: int,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
    chunk: int = 8192,
    base_row: int | jnp.ndarray = 0,
    bias: Optional[jnp.ndarray] = None,  # (V,) per-row logit bias, model space
):
    """Returns (logz, label_logit, topk_vals, topk_rows) with global row ids.

    ``base_row``: global row id of table[0] (shard offset under shard_map).
    Requires V % chunk == 0 (pad the table; padding rows are blinded).
    ``bias`` supports tied heads with a free per-item output bias
    (HeadConfig.tied_bias); indexed like ``table`` rows.
    """
    v, d = table.shape
    assert v % chunk == 0, f"table rows {v} not divisible by chunk {chunk}"
    b, p, _ = x.shape
    n = b * p
    xf = x.reshape(n, d).astype(jnp.float32)
    labels_model = jnp.where(
        labels.reshape(-1) == LABEL_PAD, -1, labels.reshape(-1) + row_offset
    )
    base_row = jnp.asarray(base_row, jnp.int32)

    def body(carry, scanned):
        m, l, g, tv, ti = carry
        table_chunk, ci = scanned[0], scanned[1]
        logits = (
            xf @ table_chunk.astype(jnp.float32).T
        )  # (n, C)
        if bias is not None:
            logits = logits + scanned[2].astype(jnp.float32)[None, :]
        rows = base_row + ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        if num_valid is not None:
            valid = (rows >= row_offset) & (rows < row_offset + num_valid)
            logits = jnp.where(valid[None, :], logits, NEG_BIG)
        # online logsumexp
        cm = jnp.max(logits, axis=1)
        m_new = jnp.maximum(m, cm)
        l = l * jnp.exp(m - m_new) + jnp.sum(
            jnp.exp(logits - m_new[:, None]), axis=1
        )
        # label logit
        onehot = rows[None, :] == labels_model[:, None]
        g = g + jnp.sum(jnp.where(onehot, logits, 0.0), axis=1)
        # running top-k: merge chunk's top-k with carry
        cv, cidx = jax.lax.top_k(logits, min(k, chunk))
        crows = rows[cidx]
        av = jnp.concatenate([tv, cv], axis=1)
        ar = jnp.concatenate([ti, crows], axis=1)
        nv, sel = jax.lax.top_k(av, k)
        nr = jnp.take_along_axis(ar, sel, axis=1)
        return (m_new, l, g, nv, nr), None

    carry0 = (
        jnp.full((n,), NEG_BIG, jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.full((n, k), NEG_BIG, jnp.float32),
        jnp.full((n, k), -1, jnp.int32),
    )
    chunks = table.reshape(v // chunk, chunk, d)
    idxs = jnp.arange(v // chunk, dtype=jnp.int32)
    scanned = (chunks, idxs)
    if bias is not None:
        scanned = scanned + (bias.reshape(v // chunk, chunk),)
    (m, l, g, tv, ti), _ = jax.lax.scan(body, carry0, scanned)
    logz = m + jnp.log(jnp.maximum(l, 1e-30))
    return (
        logz.reshape(b, p),
        g.reshape(b, p),
        tv.reshape(b, p, k),
        ti.reshape(b, p, k),
    )


def chunked_eval_stats(
    x: jnp.ndarray,
    table: jnp.ndarray,
    labels: jnp.ndarray,
    ks: Sequence[int] = (5, 10),
    row_offset: int = 0,
    num_valid: Optional[int] = None,
    chunk: int = 8192,
    bias: Optional[jnp.ndarray] = None,
) -> dict[str, jnp.ndarray]:
    """loss_sum + recall@k/NDCG@k sums, single device, any catalog size."""
    kmax = max(ks)
    logz, label_logit, _, top_rows = chunked_scores(
        x, table, labels, kmax, row_offset, num_valid, chunk, bias=bias
    )
    return ranking_sums_from_topk(
        logz, label_logit, top_rows - row_offset, labels, ks
    )

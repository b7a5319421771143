"""Chunked full-catalog eval vs dense oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath.ops.chunked_eval import chunked_eval_stats, chunked_scores
from bert4clickpath.ops.metrics import ranking_stats


def _case(b=3, p=4, d=8, v=256, nv=200, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(b, p, d)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    labels = rng.integers(0, nv, size=(b, p)).astype(np.int32)
    labels[0, 1] = LABEL_PAD
    return x, table, jnp.asarray(labels), nv


def test_chunked_matches_dense():
    x, table, labels, nv = _case()
    stats = chunked_eval_stats(
        x, table, labels, ks=(5, 10), row_offset=NUM_RESERVED_TOKENS,
        num_valid=nv, chunk=64,
    )
    dense_logits = jnp.einsum(
        "bpd,vd->bpv", x, table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + nv]
    )
    want = ranking_stats(dense_logits, labels, ks=(5, 10))
    for key in ("n", "recall@5_sum", "recall@10_sum", "ndcg@5_sum", "ndcg@10_sum"):
        np.testing.assert_allclose(
            float(stats[key]), float(want[key]), rtol=1e-5, err_msg=key
        )
    # loss_sum vs dense masked CE
    from bert4clickpath.ops.losses import masked_softmax_cross_entropy

    n = float(stats["n"])
    dense_loss = float(masked_softmax_cross_entropy(dense_logits, labels))
    np.testing.assert_allclose(float(stats["loss_sum"]) / n, dense_loss, rtol=1e-5)


def test_chunked_topk_rows_global():
    x, table, labels, nv = _case(seed=3)
    _, _, vals, rows = chunked_scores(
        x, table, labels, 5, NUM_RESERVED_TOKENS, nv, chunk=32
    )
    dense = np.einsum(
        "bpd,vd->bpv",
        np.asarray(x),
        np.asarray(table)[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + nv],
    )
    want_rows = np.argsort(-dense, axis=-1)[..., :5] + NUM_RESERVED_TOKENS
    np.testing.assert_array_equal(np.asarray(rows), want_rows)


def test_chunked_jits():
    x, table, labels, nv = _case()
    f = jax.jit(
        lambda x, t, l: chunked_eval_stats(
            x, t, l, row_offset=NUM_RESERVED_TOKENS, num_valid=nv, chunk=64
        )
    )
    stats = f(x, table, labels)
    assert np.isfinite(float(stats["loss_sum"]))


def test_pick_chunk_rows_cap():
    """Big-catalog chunks shrink when the scoring row count is large: the
    scan body holds an (rows, chunk) f32 logits tile (code-review round 4 —
    65536-chunks at a 512x25-row training eval would be a 3.4 GB tile)."""
    from bert4clickpath.ops.chunked_eval import pick_chunk

    v = 10_027_008  # 10M-row table padded to the 65536 alignment
    assert pick_chunk(v) == 65536  # serving: rows unknown/small
    assert pick_chunk(v, rows=1 * 64) == 65536  # serving bucket: P=1
    big = pick_chunk(v, rows=512 * 25)
    assert big * 512 * 25 * 4 <= (256 << 20)
    assert big >= 4096  # still far above the old tiny-chunk regime

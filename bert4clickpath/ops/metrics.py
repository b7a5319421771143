"""Streaming masked metrics as psum-able accumulator pytrees.

Replaces the reference's Keras metric objects (ClozeMaskedRecall /
ClozeMaskedNDCG, source/utils.py:137-259; binary metrics, metrics.py:5-106)
with pure functions: each ``*_stats`` returns a dict of scalar **sums** plus a
count; accumulate with :func:`merge`, reduce across the mesh with
``jax.lax.psum`` (or host-side :func:`merge` over per-step dicts), and read
rates with :func:`finalize`. This is the streaming-metric pattern that
composes with jit/pjit, unlike stateful metric objects.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import jax
import jax.numpy as jnp

from bert4clickpath.constants import LABEL_PAD


def _mask(labels: jnp.ndarray) -> jnp.ndarray:
    return (labels != LABEL_PAD).astype(jnp.float32)


def ranking_stats(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    ks: Sequence[int] = (5, 10),
) -> dict[str, jnp.ndarray]:
    """Recall@k and NDCG@k sums for single-ground-truth ranking.

    logits: (B, P, V); labels: (B, P) int with LABEL_PAD fill.

    Cloze assumption from the reference (utils.py:140-143): each masked
    position has exactly one true item, so IDCG = 1/log2(2) = 1 and
    NDCG reduces to 1/log2(rank+2) if the true item ranks within k
    (utils.py:225-233,250).
    """
    mask = _mask(labels)
    kmax = min(max(ks), logits.shape[-1])  # clamp for tiny test vocabularies
    _, topk = jax.lax.top_k(logits, kmax)  # (B, P, kmax)
    hit = (topk == labels[..., None]).astype(jnp.float32)  # one-hot over rank
    # discount[r] = 1/log2(r+2), reference utils.py:211
    discounts = 1.0 / (jnp.log(jnp.arange(2, kmax + 2, dtype=jnp.float32)) / jnp.log(2.0))
    stats: dict[str, jnp.ndarray] = {"n": jnp.sum(mask)}
    for k in ks:
        kk = min(k, kmax)
        stats[f"recall@{k}_sum"] = jnp.sum(jnp.sum(hit[..., :kk], axis=-1) * mask)
        stats[f"ndcg@{k}_sum"] = jnp.sum(
            jnp.sum(hit[..., :kk] * discounts[:kk], axis=-1) * mask
        )
    return stats


def masked_accuracy_stats(logits: jnp.ndarray, labels: jnp.ndarray) -> dict:
    """Top-1 accuracy sum over non-pad positions."""
    mask = _mask(labels)
    pred = jnp.argmax(logits, axis=-1)
    correct = (pred == labels).astype(jnp.float32) * mask
    return {"n": jnp.sum(mask), "accuracy_sum": jnp.sum(correct)}


def binary_stats(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    threshold: float = 0.5,
) -> dict[str, jnp.ndarray]:
    """Streaming counts for binary tasks over (B, P) logits / {0,1,-1} labels.

    Covers the reference's PositiveRate (metrics.py:5-26), PredictedPositives
    (metrics.py:29-51, threshold 0.5), and F1Score (metrics.py:54-86) in one
    pass. Predictions threshold the *sigmoid* of the logit.
    """
    mask = _mask(labels)
    labels_f = jnp.where(mask > 0, labels.astype(jnp.float32), 0.0)
    pred = (jax.nn.sigmoid(logits.astype(jnp.float32)) >= threshold).astype(
        jnp.float32
    ) * mask
    tp = jnp.sum(pred * labels_f)
    return {
        "n": jnp.sum(mask),
        "positives_sum": jnp.sum(labels_f),
        "pred_positives_sum": jnp.sum(pred),
        "tp_sum": tp,
    }


def masked_metric(fn, name: str):
    """Turn any per-position metric fn into a pad-masked streaming stat.

    The functional analogue of the reference's generic ``MaskedMetric``
    Keras wrapper (metrics.py:89-106), which forwarded ``labels != LABEL_PAD``
    as the inner metric's sample_weight. Here ``fn(logits, labels) -> (B, P)``
    per-position values; padded positions are zeroed and the masked sum is
    emitted as ``{name}_sum`` alongside ``n``, so the result accumulates with
    :func:`merge` / :func:`psum_stats` and reads out via :func:`finalize`
    exactly like the built-in stats.

        top3 = masked_metric(
            lambda lg, lb: (jnp.argsort(-lg, -1)[..., :3] == lb[..., None]).any(-1),
            "top3_acc",
        )
        stats = top3(logits, labels)   # {"n": ..., "top3_acc_sum": ...}

    For metrics that are NOT a per-position mean (AUC's bucketed confusion
    counts, histogram quantiles, ...), use :func:`masked_stateful_metric`.
    """

    def stats_fn(logits: jnp.ndarray, labels: jnp.ndarray) -> dict:
        mask = _mask(labels)
        vals = jnp.asarray(fn(logits, labels), jnp.float32)
        if vals.shape != labels.shape:
            raise ValueError(
                f"metric fn for {name!r} returned shape {vals.shape}; "
                f"expected per-position values of shape {labels.shape}"
            )
        return {"n": jnp.sum(mask), f"{name}_sum": jnp.sum(vals * mask)}

    return stats_fn


def masked_stateful_metric(fn):
    """Pad-masked wrapper for metrics with arbitrary (vector) accumulators.

    Covers the other half of the reference's ``MaskedMetric`` contract
    (metrics.py:89-106): Keras metrics like ``tf.keras.metrics.AUC`` keep
    internal STATE (per-threshold confusion buckets) rather than a maskable
    per-position value, and MaskedMetric forwarded the pad mask as their
    sample_weight. The streaming analogue: ``fn(logits, labels, mask) ->
    dict`` of sum-reducible arrays (scalars or vectors — :func:`merge` and
    :func:`psum_stats` add elementwise either way); this wrapper adds the
    masked-position count ``n``. Read results out with a matching finalizer
    (:func:`finalize` knows the built-in accumulator families, e.g. the
    ``auc_*`` keys from :func:`auc_stats`).
    """

    def stats_fn(logits: jnp.ndarray, labels: jnp.ndarray) -> dict:
        mask = _mask(labels)
        stats = dict(fn(logits, labels, mask))
        stats.setdefault("n", jnp.sum(mask))
        return stats

    return stats_fn


def auc_stats(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    num_thresholds: int = 200,
) -> dict[str, jnp.ndarray]:
    """Streaming ROC-AUC accumulators for binary (B, P) logits.

    The stateful metric the reference ran through MaskedMetric
    (``MaskedMetric(AUC, ...)``, metrics.py:89-106): per-threshold
    TP/FP/FN/TN counts over ``sigmoid(logit)``, thresholds laid out like
    Keras AUC (num_thresholds - 2 evenly spaced in (0, 1) plus -eps/1+eps
    endpoints). The four (T,) vectors merge/psum elementwise like every
    other accumulator; :func:`finalize` turns them into trapezoidal ROC-AUC.
    """

    def fn(logits, labels, mask):
        probs = jax.nn.sigmoid(logits.astype(jnp.float32))
        eps = 1e-7
        inner = (jnp.arange(1, num_thresholds - 1, dtype=jnp.float32)) / (
            num_thresholds - 1
        )
        thr = jnp.concatenate(
            [jnp.asarray([-eps]), inner, jnp.asarray([1.0 + eps])]
        )  # (T,)
        labels_f = jnp.where(mask > 0, labels.astype(jnp.float32), 0.0)
        flat_p, flat_y, flat_m = probs.ravel(), labels_f.ravel(), mask.ravel()
        pred = (flat_p[None, :] > thr[:, None]).astype(jnp.float32)  # (T, N)
        tp = jnp.sum(pred * (flat_y * flat_m)[None, :], axis=1)
        fp = jnp.sum(pred * ((1.0 - flat_y) * flat_m)[None, :], axis=1)
        pos = jnp.sum(flat_y * flat_m)
        neg = jnp.sum((1.0 - flat_y) * flat_m)
        return {
            "auc_tp": tp,
            "auc_fp": fp,
            "auc_fn": pos - tp,
            "auc_tn": neg - fp,
        }

    return masked_stateful_metric(fn)(logits, labels)


def merge(*stats: Mapping[str, jnp.ndarray]) -> dict:
    """Elementwise-add accumulators (host or device side)."""
    out = dict(stats[0])
    for s in stats[1:]:
        for k, v in s.items():
            out[k] = out[k] + v if k in out else v
    return out


def psum_stats(stats: Mapping[str, jnp.ndarray], axis_name: str) -> dict:
    return {k: jax.lax.psum(v, axis_name) for k, v in stats.items()}


def finalize(stats: Mapping[str, jnp.ndarray]) -> dict[str, float]:
    """Turn sums into rates: every ``*_sum`` key divided by ``n``."""
    n = float(stats["n"])
    out: dict[str, float] = {"n": n}
    denom = max(n, 1.0)
    for k, v in stats.items():
        if k.endswith("_sum"):
            out[k[: -len("_sum")]] = float(v) / denom
    # Derived binary metrics (reference F1: metrics.py:80-81)
    if "tp_sum" in stats:
        tp = float(stats["tp_sum"])
        denom_f1 = float(stats["positives_sum"]) + float(stats["pred_positives_sum"])
        out["f1"] = 2.0 * tp / denom_f1 if denom_f1 > 0 else 0.0
    # Stateful-accumulator families (masked_stateful_metric): bucketed ROC-AUC
    # from auc_stats' per-threshold confusion counts, trapezoidal like Keras
    if "auc_tp" in stats:
        import numpy as np

        tp = np.asarray(stats["auc_tp"], np.float64)
        fp = np.asarray(stats["auc_fp"], np.float64)
        fn_ = np.asarray(stats["auc_fn"], np.float64)
        tn = np.asarray(stats["auc_tn"], np.float64)
        tpr = tp / np.maximum(tp + fn_, 1e-12)
        fpr = fp / np.maximum(fp + tn, 1e-12)
        # thresholds ascend -> (fpr, tpr) descend; trapezoid over the ROC
        out["auc"] = float(
            np.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
        )
    return out

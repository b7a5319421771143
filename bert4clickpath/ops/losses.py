"""Masked losses over padded variable-length label tensors.

Reworks the reference's ``MaskedLoss`` (losses.py:5-98) and
``ClozeMaskedLoss``/``cloze_output_adaptor`` (source/utils.py:56-134) the
static-shape way:

* Shapes are **static** — labels are always ``(B, P)`` with ``LABEL_PAD``
  fill, so the entire per-replica-pad adaptor (utils.py:76-90) disappears.
* Losses take **logits** (reference heads emitted probabilities,
  head.py:21,45 — numerically inferior, not replicated).
* Normalization is **global by construction**: ``psum(sum item_loss) /
  psum(sum mask)`` across the ``data`` mesh axis replaces the empty-subbatch
  NaN guard (losses.py:83-91). Division is guarded with ``maximum(n, 1)``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from bert4clickpath.constants import LABEL_PAD


def _global_mean(total: jnp.ndarray, count: jnp.ndarray, axis_name: Optional[str]):
    if axis_name is not None:
        total = jax.lax.psum(total, axis_name)
        count = jax.lax.psum(count, axis_name)
    return total / jnp.maximum(count, 1.0)


def masked_mean(
    item_losses: jnp.ndarray,
    labels: jnp.ndarray,
    label_pad: int = LABEL_PAD,
    weights: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Mean of ``item_losses`` over positions where ``labels != label_pad``.

    The generic reduction shared by every masked loss; equivalent to the
    reference ``MaskedLoss.call``'s mask/sum/divide (losses.py:50-91) but with
    a psum so multi-device normalization is exact.
    """
    mask = (labels != label_pad).astype(item_losses.dtype)
    if weights is not None:
        item_losses = item_losses * weights
    total = jnp.sum(item_losses * mask)
    count = jnp.sum(mask)
    return _global_mean(total, count, axis_name)


def softmax_ce_items(
    logits: jnp.ndarray, labels: jnp.ndarray, label_pad: int = LABEL_PAD
) -> jnp.ndarray:
    """Per-position NLL (no reduction, no collectives) — the item-wise inner
    loss the reference wraps in MaskedLoss (losses.py:18). Exposed so SPMD
    steps can reduce with explicit psums OUTSIDE autodiff (differentiating
    through collectives under shard_map(check_vma=False) mis-derives
    transposes)."""
    logits = logits.astype(jnp.float32)  # CE in f32 even under bf16 compute
    safe_labels = jnp.where(labels == label_pad, 0, labels)
    logz = jax.nn.logsumexp(logits, axis=-1)
    label_logit = jnp.take_along_axis(
        logits, safe_labels[..., None].astype(jnp.int32), axis=-1
    )[..., 0]
    return logz - label_logit


def masked_softmax_cross_entropy(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    label_pad: int = LABEL_PAD,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Sparse softmax CE over (B, P, V) logits / (B, P) int labels with pads.

    The Cloze training loss (reference: sparse_categorical_crossentropy under
    ClozeMaskedLoss, source/main.py:89). Pad labels are shifted to class 0
    before the gather — they are masked out of the mean, mirroring the
    reference's pad-to-zero trick (losses.py:57-58).
    """
    nll = softmax_ce_items(logits, labels, label_pad)
    return masked_mean(nll, labels, label_pad, axis_name=axis_name)


def binary_ce_items(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    label_pad: int = LABEL_PAD,
    pos_weight: Optional[float] = None,
):
    """Per-position weighted BCE pieces (no reduction, no collectives).

    Returns ``(nll, weights, scale)``: per-item loss, per-item weights (None
    without pos_weight), and the static (pos_weight+1)/2 normalizer that puts
    the weighted mean back on the unweighted scale (reference
    losses.py:71-96). SPMD steps reduce these with psums outside autodiff.
    """
    logits = logits.astype(jnp.float32)
    labels_f = labels.astype(jnp.float32)
    safe = jnp.where(labels_f == label_pad, 0.0, labels_f)
    # Stable BCE-with-logits: max(x,0) - x*z + log1p(exp(-|x|))
    nll = jnp.maximum(logits, 0.0) - logits * safe + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    weights = None
    scale = 1.0
    if pos_weight is not None:
        weights = jnp.where(safe == 1.0, jnp.float32(pos_weight), 1.0)
        scale = (pos_weight + 1.0) / 2.0
    return nll, weights, scale


def masked_binary_cross_entropy(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    label_pad: int = LABEL_PAD,
    pos_weight: Optional[float] = None,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Binary CE from logits over (B, P) with -1 pads.

    Matches reference ``MaskedLoss`` with ``pos_weight`` semantics: positives
    weighted by ``pos_weight``, negatives by 1, and the result normalized by
    ``(pos_weight + 1) / 2`` to stay on the unweighted scale
    (losses.py:71-96).
    """
    nll, weights, scale = binary_ce_items(logits, labels, label_pad, pos_weight)
    loss = masked_mean(nll, labels, label_pad, weights=weights, axis_name=axis_name)
    return loss / scale


def masked_multilabel_cross_entropy(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    label_pad: int = LABEL_PAD,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Independent-sigmoid CE over (B, C) multi-hot labels with -1 pads.

    Loss for the ``multilabel`` head (reference head.py:50-69 wired through
    MaskedLoss with binary_crossentropy).
    """
    return masked_binary_cross_entropy(
        logits, labels, label_pad=label_pad, axis_name=axis_name
    )


def sampled_softmax_ce(
    x: jnp.ndarray,  # (N, D) head inputs
    table: jnp.ndarray,  # (V, D) catalog rows (model space)
    labels: jnp.ndarray,  # (N,) label-space ids, LABEL_PAD allowed
    row_offset: int,
    num_valid: int,
    num_samples: int,
    rng: jnp.ndarray,
    bias: Optional[jnp.ndarray] = None,  # (V,) model-space logit bias
) -> jnp.ndarray:
    """Per-row sampled-softmax NLL over a tied catalog projection.

    The training-throughput escape hatch at very large catalogs (SURVEY §7
    stage 6 "tied-weight projection/sampled-softmax"): instead of streaming
    all V rows through the fused CE kernel, draw ``num_samples``
    batch-shared uniform negatives, so the per-step head cost drops from
    O(N·V·D) to O(N·S·D + S·D). Eval stays exact (chunked catalog scan).

    Standard corrections (the tf.nn.sampled_softmax_loss contract the
    reference ecosystem assumes): negatives get ``+log(num_valid /
    num_samples)`` (the -log Q(class) importance correction for a uniform
    sampler; the always-present positive has Q=1), and accidental hits
    (negative == row's own label) are blinded. With-replacement sampling:
    at S << V collisions are negligible and the estimator stays simple.

    Returns nll (N,) f32 with 0 at LABEL_PAD rows; differentiable wrt x,
    table and bias (gathers scatter-add under autodiff — only S+N rows of
    the table receive gradient, which is the point).
    """
    neg_lab = jax.random.randint(rng, (num_samples,), 0, num_valid)
    lab_safe = jnp.maximum(labels, 0)
    w_pos = table[lab_safe + row_offset].astype(x.dtype)  # (N, D)
    w_neg = table[neg_lab + row_offset].astype(x.dtype)  # (S, D)
    pos = jnp.einsum("nd,nd->n", x, w_pos, preferred_element_type=jnp.float32)
    neg = jnp.einsum("nd,sd->ns", x, w_neg, preferred_element_type=jnp.float32)
    if bias is not None:
        b = bias.astype(jnp.float32)
        pos = pos + b[lab_safe + row_offset]
        neg = neg + b[neg_lab + row_offset]
    # importance correction, then accidental-hit blinding
    neg = neg + jnp.log(jnp.float32(num_valid) / jnp.float32(num_samples))
    hit = neg_lab[None, :] == lab_safe[:, None]
    neg = jnp.where(hit, -1e30, neg)
    m = jnp.maximum(pos, jnp.max(neg, axis=-1))
    logz = m + jnp.log(
        jnp.exp(pos - m) + jnp.sum(jnp.exp(neg - m[:, None]), axis=-1)
    )
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    return (logz - pos) * mask

"""Ranking/binary metric tests, including the sklearn NDCG oracle the
reference used as its only automated check (source/utils.py:262-277)."""

import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.ops import metrics as M


def test_ndcg_matches_reference_example():
    # The reference __main__ oracle (utils.py:262-277): two masked positions,
    # labels [1, 0], 3-class predictions; sklearn ndcg_score agrees.
    logits = jnp.asarray(
        [[[0.9, 0.1, 0.01], [0.5, 0.3, 0.01]]], dtype=jnp.float32
    )  # (1, 2, 3)
    labels = jnp.asarray([[1, 0]])
    stats = M.finalize({k: np.asarray(v) for k, v in M.ranking_stats(logits, labels, ks=(3,)).items()})
    # position 0: true item 1 ranks 2nd -> 1/log2(3); position 1: true item 0
    # ranks 1st -> 1. mean = 0.8154648...
    want = (1.0 / np.log2(3.0) + 1.0) / 2.0
    assert np.isclose(stats["ndcg@3"], want, rtol=1e-6)

    sklearn = pytest.importorskip("sklearn.metrics")
    sk = sklearn.ndcg_score(
        [[0, 1, 0], [1, 0, 0]], [[0.9, 0.1, 0.01], [0.5, 0.3, 0.01]], k=3
    )
    assert np.isclose(stats["ndcg@3"], sk, rtol=1e-6)


def test_recall_at_k():
    logits = jnp.asarray(
        [
            [
                [0.1, 0.9, 0.0, 0.0],  # label 1 -> rank 0, hit@1
                [0.4, 0.3, 0.2, 0.1],  # label 3 -> rank 3, miss@2
            ]
        ]
    )
    labels = jnp.asarray([[1, 3]])
    stats = M.finalize(
        {k: np.asarray(v) for k, v in M.ranking_stats(logits, labels, ks=(2, 4)).items()}
    )
    assert stats["recall@2"] == 0.5
    assert stats["recall@4"] == 1.0
    assert stats["n"] == 2


def test_pad_positions_excluded():
    logits = jnp.ones((2, 3, 4))
    labels = jnp.asarray([[0, -1, -1], [1, 2, -1]])
    stats = M.ranking_stats(logits, labels, ks=(2,))
    assert float(stats["n"]) == 3.0


def test_merge_and_psum_shape():
    logits = jnp.ones((1, 2, 4))
    labels = jnp.asarray([[0, 1]])
    s1 = M.ranking_stats(logits, labels)
    s2 = M.ranking_stats(logits, labels)
    merged = M.merge(s1, s2)
    assert float(merged["n"]) == 4.0


def test_binary_stats_and_f1():
    logits = jnp.asarray([[5.0, -5.0, 5.0, -5.0]])  # preds: 1, 0, 1, 0
    labels = jnp.asarray([[1, 1, 0, -1]])  # tp=1, fp=1, fn=1; last padded
    stats = M.finalize({k: np.asarray(v) for k, v in M.binary_stats(logits, labels).items()})
    assert stats["n"] == 3
    assert np.isclose(stats["positives"], 2 / 3)
    assert np.isclose(stats["pred_positives"], 2 / 3)
    # F1 = 2*tp/(condition_true + predicted_true) (reference metrics.py:80-81)
    assert np.isclose(stats["f1"], 2 * 1 / (2 + 2))


def test_masked_accuracy():
    logits = jnp.asarray([[[0.0, 9.0], [9.0, 0.0]]])
    labels = jnp.asarray([[1, 1]])
    stats = M.finalize(
        {k: np.asarray(v) for k, v in M.masked_accuracy_stats(logits, labels).items()}
    )
    assert stats["accuracy"] == 0.5


def test_masked_metric_generic_wrapper():
    """masked_metric turns a user fn into a pad-masked stat (reference
    MaskedMetric, metrics.py:89-106: mask = labels != LABEL_PAD forwarded as
    sample_weight)."""
    import jax.numpy as jnp

    from bert4clickpath.constants import LABEL_PAD
    from bert4clickpath.ops.metrics import finalize, masked_metric, merge

    top1 = masked_metric(
        lambda lg, lb: (jnp.argmax(lg, -1) == lb).astype(jnp.float32), "top1"
    )
    logits = jnp.asarray(
        [[[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], [[0.0, 0.0, 1.0], [0.5, 0.4, 0.1]]]
    )
    labels = jnp.asarray([[1, LABEL_PAD], [2, 0]])  # pad position must not count
    stats = top1(logits, labels)
    assert float(stats["n"]) == 3.0
    out = finalize(merge(stats, stats))
    assert out["top1"] == 1.0  # all non-pad predictions correct, pad ignored

    # wrong-shaped user fn is an error, not a silent broadcast
    bad = masked_metric(lambda lg, lb: lg, "bad")
    try:
        bad(logits, labels)
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_auc_streaming_matches_sklearn():
    """auc_stats (the stateful-accumulator analogue of the reference's
    MaskedMetric(AUC), metrics.py:89-106) agrees with sklearn's exact
    roc_auc_score to bucket resolution, streams via merge across batches,
    and excludes pad positions."""
    import jax.numpy as jnp

    from bert4clickpath.constants import LABEL_PAD
    from bert4clickpath.ops.metrics import auc_stats, finalize, merge

    sklearn = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(0)
    n = 512
    y = rng.integers(0, 2, size=n)
    # informative but noisy scores so AUC is strictly between 0.5 and 1
    logit = 1.5 * (2.0 * y - 1.0) + rng.normal(size=n)
    want = sklearn.roc_auc_score(y, 1.0 / (1.0 + np.exp(-logit)))

    logits = jnp.asarray(logit.reshape(4, 8, 16), jnp.float32)
    labels = jnp.asarray(y.reshape(4, 8, 16), jnp.int32)
    stats = None
    for b in range(4):  # stream batch-by-batch, accumulate with merge
        s = auc_stats(logits[b], labels[b])
        stats = s if stats is None else merge(stats, s)
    got = finalize({k: np.asarray(v) for k, v in stats.items()})
    assert got["n"] == n
    assert np.isclose(got["auc"], want, atol=5e-3)

    # pad positions are excluded: padding half the labels changes the count
    # and matches sklearn on the surviving half
    labels_pad = np.array(labels[0])
    labels_pad[:, 8:] = LABEL_PAD
    s = auc_stats(logits[0], jnp.asarray(labels_pad))
    keep = labels_pad != LABEL_PAD
    want_half = sklearn.roc_auc_score(
        np.asarray(labels[0])[keep],
        1.0 / (1.0 + np.exp(-np.asarray(logits[0])[keep])),
    )
    out = finalize({k: np.asarray(v) for k, v in s.items()})
    assert out["n"] == keep.sum()
    assert np.isclose(out["auc"], want_half, atol=1e-2)

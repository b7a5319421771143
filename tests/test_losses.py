"""Masked-loss tests vs hand-computed values.

Oracle values mirror the reference MaskedLoss semantics (losses.py:31-98):
mean of per-item losses over non-pad positions, with the pos_weight
normalization of losses.py:94-96; plus the all-pad (empty batch) guard."""

import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.ops.losses import (
    masked_binary_cross_entropy,
    masked_mean,
    masked_softmax_cross_entropy,
)


def _softmax_nll(logits, label):
    logits = np.asarray(logits, np.float64)
    z = np.log(np.sum(np.exp(logits)))
    return z - logits[label]


def test_masked_mean_ignores_pads():
    losses = jnp.array([[1.0, 2.0], [3.0, 4.0]])
    labels = jnp.array([[5, -1], [7, 8]])
    got = masked_mean(losses, labels)
    assert np.isclose(got, (1.0 + 3.0 + 4.0) / 3.0)


def test_masked_mean_empty_batch_guard():
    # All-pad labels must give 0, not NaN (reference losses.py:83-91).
    losses = jnp.ones((2, 3))
    labels = jnp.full((2, 3), -1)
    assert float(masked_mean(losses, labels)) == 0.0


def test_softmax_ce_matches_hand_value():
    logits = np.array(
        [[[2.0, 0.5, -1.0], [0.1, 0.2, 0.3]], [[1.0, 1.0, 1.0], [0.0, 0.0, 9.0]]],
        np.float32,
    )
    labels = np.array([[0, -1], [2, 2]])
    want = (
        _softmax_nll(logits[0, 0], 0)
        + _softmax_nll(logits[1, 0], 2)
        + _softmax_nll(logits[1, 1], 2)
    ) / 3.0
    got = float(masked_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert np.isclose(got, want, rtol=1e-5)


def test_softmax_ce_all_pad_is_zero():
    logits = jnp.zeros((2, 3, 5))
    labels = jnp.full((2, 3), -1)
    assert float(masked_softmax_cross_entropy(logits, labels)) == 0.0


def _bce(logit, z):
    # stable bce-with-logits reference
    x = float(logit)
    return max(x, 0.0) - x * z + np.log1p(np.exp(-abs(x)))


def test_binary_ce_hand_value():
    logits = np.array([[0.3, -1.2, 2.0]], np.float32)
    labels = np.array([[1, 0, -1]])
    want = (_bce(0.3, 1) + _bce(-1.2, 0)) / 2.0
    got = float(masked_binary_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert np.isclose(got, want, rtol=1e-5)


def test_binary_ce_pos_weight_normalization():
    # pos_weight w: positives weighted w, negatives 1, result divided by
    # (w+1)/2 (reference losses.py:71-73,94-96).
    logits = np.array([[0.3, -1.2]], np.float32)
    labels = np.array([[1, 0]])
    w = 3.0
    raw = (w * _bce(0.3, 1) + _bce(-1.2, 0)) / 2.0
    want = raw / ((w + 1) / 2)
    got = float(
        masked_binary_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), pos_weight=w
        )
    )
    assert np.isclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("pad_label", [0, 4])
def test_pad_positions_never_leak(pad_label):
    # Whatever garbage sits in logits at padded positions must not affect
    # the loss (the reference shifted pads to class 0 first, losses.py:57-58).
    logits = np.zeros((1, 2, 5), np.float32)
    labels = np.array([[pad_label, -1]])
    base = float(masked_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    logits2 = logits.copy()
    logits2[0, 1] = 1e3  # perturb only the padded position
    got = float(masked_softmax_cross_entropy(jnp.asarray(logits2), jnp.asarray(labels)))
    assert np.isclose(base, got)


def test_sampled_softmax_approximates_dense_ce():
    """sampled_softmax_ce with the log(V/S) importance correction estimates
    the exact CE; with S == V coverage it converges tightly, pads return 0,
    accidental hits never blow up duplicate-label batches."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath.constants import LABEL_PAD
    from bert4clickpath.ops.losses import sampled_softmax_ce

    rng = np.random.default_rng(0)
    V, D, N, off = 64, 16, 32, 10
    table = jnp.asarray(rng.normal(size=(V + off, D)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, V, size=(N,)), jnp.int32)
    labels = labels.at[0].set(LABEL_PAD)
    labels = labels.at[1].set(labels[2])  # duplicate labels

    logits = x @ table[off : off + V].T
    dense = -jax.nn.log_softmax(logits, axis=-1)[
        jnp.arange(N), jnp.maximum(labels, 0)
    ] * (labels != LABEL_PAD)

    # average the estimator over independent negative draws
    keys = jax.random.split(jax.random.PRNGKey(1), 64)
    ests = jnp.stack(
        [
            sampled_softmax_ce(x, table, labels, off, V, 256, k)
            for k in keys
        ]
    )
    assert float(ests[0, 0]) == 0.0  # pad row
    mask = np.asarray(labels) != LABEL_PAD
    est = np.asarray(ests.mean(0))[mask]
    want = np.asarray(dense)[mask]
    # logsumexp of a subsample underestimates => small downward bias; the
    # correction keeps it within a few percent at S=4V
    np.testing.assert_allclose(est, want, rtol=0.15, atol=0.05)
    assert np.all(np.isfinite(np.asarray(ests)))


def test_sampled_softmax_trains_tied_model():
    """make_train_step(sampled_softmax_samples=S): loss falls and the exact
    (dense) CE falls with it — the estimator's gradients point the right way."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath import (
        ClickstreamModel,
        FeatureConfig,
        HeadConfig,
        ModelConfig,
        TrainConfig,
    )
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.data.pipeline import ClozeDataset
    from bert4clickpath.ops.losses import masked_softmax_cross_entropy
    from bert4clickpath.training import schedules
    from bert4clickpath.training.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    gen = ClickStreamGenerator(n_items=128, session_cohesiveness=200, seed=0)
    vocab = gen.item_vocab()
    items, _ = gen.generate_sessions(64)
    ds = ClozeDataset(items, vocab, max_items=20)
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=1, num_heads=2, ffn_dim=64, max_len=23,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
    )
    model = ClickstreamModel(cfg)
    b = next(ds.train_batches(16, seed=0))
    batch = {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        batch["features"], batch["head_positions"],
    )
    tx = make_optimizer(TrainConfig(batch_size=16))
    step = make_train_step(
        model, tx, schedules.constant(1e-2),
        fused_ce_num_valid=vocab.label_vocab_size,
        sampled_softmax_samples=32,
    )

    def dense_ce(params):
        logits = model.apply(
            params, batch["features"], batch["head_positions"],
            deterministic=True,
        )
        return float(
            masked_softmax_cross_entropy(
                logits[..., : vocab.label_vocab_size], batch["labels"]
            )
        )

    state = TrainState.create(params, tx)
    before = dense_ce(state.params)
    rng = jax.random.PRNGKey(1)
    for _ in range(30):
        state, loss = step(state, batch, rng)
    after = dense_ce(state.params)
    assert np.isfinite(float(loss))
    assert after < before - 0.5, (before, after)

    # guard: sampled without num_valid is an error
    import pytest

    with pytest.raises(ValueError, match="sampled_softmax_samples"):
        make_train_step(
            model, tx, schedules.constant(1e-2), sampled_softmax_samples=8
        )

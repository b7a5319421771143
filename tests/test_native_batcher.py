"""Native (C++/OpenMP) batch builder vs the numpy reference path."""

import numpy as np
import pytest

from bert4clickpath.constants import LABEL_PAD, MASK_ID
from bert4clickpath.data import native
from bert4clickpath.data.cloze import ITEM_OFFSET
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.vocab import Vocabulary

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native batcher unavailable (no g++?)"
)


def _dataset(backend):
    vocab = Vocabulary([f"i{k}" for k in range(60)])
    rng = np.random.default_rng(0)
    seqs = [
        rng.integers(0, 60, size=rng.integers(5, 51)).astype(np.int32)
        for _ in range(64)
    ]
    return ClozeDataset(seqs, vocab, max_items=50, backend=backend)


def test_eval_identical_to_numpy():
    ds_n = _dataset("native")
    ds_p = _dataset("numpy")
    for bn, bp in zip(ds_n.eval_batches(16), ds_p.eval_batches(16)):
        np.testing.assert_array_equal(bn.features["items"], bp.features["items"])
        np.testing.assert_array_equal(bn.head_positions, bp.head_positions)
        np.testing.assert_array_equal(bn.labels, bp.labels)


def test_train_batch_invariants():
    ds = _dataset("native")
    it = ds.train_batches(16, seed=3)
    for _ in range(5):
        b = next(it)
        tokens, pos, labels = b.features["items"], b.head_positions, b.labels
        for i in range(16):
            valid = labels[i] != LABEL_PAD
            n_masked = int(valid.sum())
            # masked slots are contiguous from 0
            assert (labels[i][:n_masked] != LABEL_PAD).all()
            # positions point at MASK tokens, sorted, labels in vocab range
            if n_masked:
                assert (tokens[i][pos[i][:n_masked]] == MASK_ID).all()
                assert (np.diff(pos[i][:n_masked]) > 0).all()
                assert (labels[i][:n_masked] >= 0).all()
                assert (labels[i][:n_masked] < 60).all()
        # masking fraction statistics: floor(0.4*n) capped at 10
        assert (labels != LABEL_PAD).sum() > 0


def test_train_mask_count_matches_protocol():
    vocab = Vocabulary([f"i{k}" for k in range(60)])
    seqs = [np.arange(21, dtype=np.int32) % 60 for _ in range(8)]  # n=20 after drop
    ds = ClozeDataset(seqs, vocab, max_items=50, backend="native")
    b = next(ds.train_batches(8, seed=0))
    for i in range(8):
        assert int((b.labels[i] != LABEL_PAD).sum()) == 8  # floor(20*0.4)


def test_train_deterministic():
    ds = _dataset("native")
    b1 = next(ds.train_batches(16, seed=7))
    b2 = next(ds.train_batches(16, seed=7))
    np.testing.assert_array_equal(b1.features["items"], b2.features["items"])
    np.testing.assert_array_equal(b1.labels, b2.labels)
    b3 = next(ds.train_batches(16, seed=8))
    assert not np.array_equal(b1.features["items"], b3.features["items"])


def test_drop_last_semantics():
    vocab = Vocabulary([f"i{k}" for k in range(60)])
    seqs = [np.arange(6, dtype=np.int32)]
    ds = ClozeDataset(seqs, vocab, max_items=50, backend="native")
    b = next(ds.train_batches(1, seed=0))
    t = b.features["items"][0]
    # only items 0..4 present (drop-last), item 5 never appears
    present = set(t[t >= 10] - 10) | set(b.labels[0][b.labels[0] != LABEL_PAD])
    assert 5 not in present
    assert t[ITEM_OFFSET + 5] == 0  # padded beyond the 5 remaining items

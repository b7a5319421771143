"""Cloze masking + pipeline tests.

Pins the reference protocol: train = drop-last + random 40% <= 10 masks
(input_pipeline.py:99-114), eval = last-item mask (input_pipeline.py:115-120),
and the token layout [CLS][SEP] items [PAD]... [SEP]."""

import numpy as np

from bert4clickpath.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath.data.cloze import (
    ITEM_OFFSET,
    make_eval_batch,
    make_train_batch,
    pad_batch,
    token_length,
)
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.vocab import Vocabulary


def _seqs():
    return [np.arange(10, dtype=np.int32), np.arange(5, dtype=np.int32) + 3]


def test_token_layout():
    batch = make_eval_batch(_seqs(), max_items=12)
    t = batch.features["items"]
    assert t.shape == (2, token_length(12))
    assert (t[:, 0] == CLS_ID).all()
    assert (t[:, 1] == SEP_ID).all()
    assert (t[:, -1] == SEP_ID).all()
    # row 1: 5 items then pads
    assert (t[1, ITEM_OFFSET + 5 : -1] == PAD_ID).all()


def test_eval_masks_last_item_only():
    batch = make_eval_batch(_seqs(), max_items=12)
    t = batch.features["items"]
    # row 0: 10 items, last masked
    assert t[0, ITEM_OFFSET + 9] == MASK_ID
    assert (t[0, ITEM_OFFSET : ITEM_OFFSET + 9] == np.arange(9) + NUM_RESERVED_TOKENS).all()
    assert batch.labels[0, 0] == 9
    assert (batch.labels[0, 1:] == LABEL_PAD).all()
    assert batch.head_positions[0, 0] == ITEM_OFFSET + 9


def test_train_drops_last_and_masks_40pct():
    rng = np.random.default_rng(0)
    seq = np.arange(20, dtype=np.int32)
    batch = make_train_batch([seq], rng, max_items=25)
    t = batch.features["items"][0]
    # drop-last: only 19 items present
    assert t[ITEM_OFFSET + 19] == PAD_ID
    # n_masked = floor(19 * 0.4) = 7
    n_masked = int((batch.labels[0] != LABEL_PAD).sum())
    assert n_masked == 7
    assert (t[batch.head_positions[0][:n_masked]] == MASK_ID).all()
    # labels match the original items at masked positions
    for j in range(n_masked):
        pos = batch.head_positions[0, j] - ITEM_OFFSET
        assert batch.labels[0, j] == seq[pos]
    # positions are sorted (order-preserving choice, input_pipeline.py:29-30)
    assert (np.diff(batch.head_positions[0][:n_masked]) > 0).all()


def test_train_mask_cap_at_10():
    rng = np.random.default_rng(0)
    seq = np.arange(50, dtype=np.int32)
    batch = make_train_batch([seq], rng, max_items=50)
    n_masked = int((batch.labels[0] != LABEL_PAD).sum())
    assert n_masked == 10  # floor(49*0.4)=19 clipped to 10


def test_train_short_sequence_zero_masks():
    rng = np.random.default_rng(0)
    seq = np.arange(3, dtype=np.int32)  # after drop-last n=2, floor(0.8)=0
    batch = make_train_batch([seq], rng, max_items=50)
    assert (batch.labels[0] == LABEL_PAD).all()


def test_determinism():
    seqs = [np.arange(30, dtype=np.int32)] * 4
    b1 = make_train_batch(seqs, np.random.default_rng(7), max_items=50)
    b2 = make_train_batch(seqs, np.random.default_rng(7), max_items=50)
    np.testing.assert_array_equal(b1.features["items"], b2.features["items"])
    np.testing.assert_array_equal(b1.labels, b2.labels)


def test_pad_batch():
    batch = make_eval_batch(_seqs(), max_items=12)
    padded = pad_batch(batch, 5)
    assert padded.batch_size == 5
    assert (padded.labels[2:] == LABEL_PAD).all()
    assert (padded.features["items"][2:, 0] == CLS_ID).all()


def test_dataset_streams():
    vocab = Vocabulary([f"i{k}" for k in range(40)])
    seqs = [np.arange(5 + (i % 20), dtype=np.int32) for i in range(30)]
    ds = ClozeDataset(seqs, vocab, max_items=30)
    it = ds.train_batches(8, seed=0)
    b = next(it)
    assert b.batch_size == 8
    evs = list(ds.eval_batches(8))
    assert len(evs) == 4  # ceil(30/8)
    assert all(e.batch_size == 8 for e in evs)
    # every sequence evaluated exactly once
    total_eval_labels = sum(int((e.labels != LABEL_PAD).sum()) for e in evs)
    assert total_eval_labels == 30


def test_dataset_host_sharding():
    vocab = Vocabulary([f"i{k}" for k in range(10)])
    seqs = [np.arange(6, dtype=np.int32)] * 10
    d0 = ClozeDataset(seqs, vocab, process_index=0, process_count=2)
    d1 = ClozeDataset(seqs, vocab, process_index=1, process_count=2)
    assert len(d0) == len(d1) == 5


def test_train_batch_larger_than_dataset_raises():
    # Found by verification probing: used to busy-loop forever.
    import pytest

    vocab = Vocabulary([f"i{k}" for k in range(10)])
    ds = ClozeDataset([np.arange(6, dtype=np.int32)] * 3, vocab)
    with pytest.raises(ValueError):
        next(ds.train_batches(8, seed=0))


def test_prefetch_to_device_preserves_order():
    from bert4clickpath.data.pipeline import prefetch_to_device

    vocab = Vocabulary([f"i{k}" for k in range(20)])
    seqs = [np.arange(6, dtype=np.int32)] * 40
    ds = ClozeDataset(seqs, vocab, max_items=10)
    plain = list(ds.eval_batches(8))
    pre = list(prefetch_to_device(ds.eval_batches(8), lambda b: b, depth=3))
    assert len(plain) == len(pre)
    for a, b in zip(plain, pre):
        np.testing.assert_array_equal(a.features["items"], b.features["items"])

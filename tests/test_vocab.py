"""Vocabulary + reserved-token contract tests.

Pins the two id spaces of the reference: model space = reserved(10) + vocab +
1 OOV bucket (clickstream_transformer.py:247-258), label space = raw vocab +
OOV (input_pipeline.py:187-192)."""

import numpy as np
import pytest

from bert4clickpath.constants import (
    CLS_ID,
    MASK_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    RESERVED_TOKENS,
    SEP_ID,
    UNK_ID,
)
from bert4clickpath.vocab import Vocabulary


def test_reserved_token_ids():
    assert len(RESERVED_TOKENS) == NUM_RESERVED_TOKENS == 10
    assert PAD_ID == 0
    # The reference's INPUT_MASK constant was buggy (computed from [UNK],
    # constants.py:28); the faithful id of '[MASK]' is 1.
    assert MASK_ID == 1
    assert UNK_ID == 2
    assert CLS_ID == 3
    assert SEP_ID == 4


def test_model_space_offsets():
    v = Vocabulary(["a", "b", "c"])
    assert v.size == 3
    assert v.model_vocab_size == 10 + 3 + 1
    np.testing.assert_array_equal(v.encode_model(["a", "b", "c"]), [10, 11, 12])
    # OOV bucket
    assert v.encode_model(["zzz"])[0] == v.model_oov_id == 13
    # reserved strings map to reserved rows
    assert v.encode_model(["[MASK]"])[0] == MASK_ID


def test_label_space():
    v = Vocabulary(["a", "b", "c"])
    np.testing.assert_array_equal(v.encode_labels(["c", "a"]), [2, 0])
    with pytest.raises(KeyError):
        v.encode_labels(["zzz"])
    assert v.encode_labels(["zzz"], allow_oov=True)[0] == 3
    np.testing.assert_array_equal(
        Vocabulary.label_to_model(np.array([0, 2, -1])), [10, 12, -1]
    )


def test_decode_roundtrip():
    v = Vocabulary(["x", "y"])
    assert v.decode_label(1) == "y"
    assert v.decode_model(11) == "y"
    assert v.decode_model(MASK_ID) == "[MASK]"


def test_rejects_reserved_and_duplicates():
    with pytest.raises(ValueError):
        Vocabulary(["a", "a"])
    with pytest.raises(ValueError):
        Vocabulary(["[PAD]"])


def test_from_corpus_first_appearance_order():
    v = Vocabulary.from_corpus(["b", "a", "b", "c", "a"])
    assert v.tokens == ["b", "a", "c"]


def test_file_roundtrip(tmp_path):
    v = Vocabulary(["alpha", "beta"])
    path = str(tmp_path / "vocab.txt")
    v.save(path)
    v2 = Vocabulary.from_file(path)
    assert v2.tokens == v.tokens
    with pytest.raises(IsADirectoryError):
        Vocabulary.from_file(str(tmp_path))


def test_artifact_roundtrip(tmp_path):
    v = Vocabulary(["alpha", "beta"])
    v.save_artifact(str(tmp_path), "items")
    v2 = Vocabulary.load_artifact(str(tmp_path), "items")
    assert v2.tokens == v.tokens

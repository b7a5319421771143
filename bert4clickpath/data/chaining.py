"""[CLS]/[SEP] sequence chaining at static offsets.

Reference semantics (TransformerInputPrep, clickstream_transformer.py:8-103):
chained input is ``[CLS] [SEP] seq_1 [SEP] seq_2 [SEP] ...``, segment 0 is
the CLS summary, segment i is seq_i. The reference recomputed SEP positions
at runtime from batch row 0 (clickstream_transformer.py:81-94); here every
sequence slot has a *fixed* padded length, so segment boundaries are
compile-time constants — ``segment_bounds(i)`` feeds
``ModelConfig.segment_bounds`` directly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bert4clickpath.constants import CLS_ID, SEP_ID


def chained_length(segment_lengths: Sequence[int]) -> int:
    """Total token length: [CLS][SEP] + sum(L_i + 1 trailing SEP each)."""
    return 2 + sum(l + 1 for l in segment_lengths)


def segment_bounds(segment_lengths: Sequence[int], segment: int) -> tuple[int, int]:
    """[start, end) token range of ``segment`` (0 = the CLS token).

    Matches the reference's segment_starts/ends arithmetic
    (clickstream_transformer.py:92-94, 317-322): segment 0 -> (0, 1),
    segment i -> the seq_i span (its trailing SEP excluded).
    """
    if segment == 0:
        return (0, 1)
    start = 2
    for i, length in enumerate(segment_lengths, start=1):
        if i == segment:
            return (start, start + length)
        start += length + 1
    raise ValueError(f"segment {segment} out of range")


def chain_sequences(padded_seqs: Sequence[np.ndarray]) -> np.ndarray:
    """Chain (B, L_i) int32 model-space padded sequences into
    (B, chained_length) tokens: ``[CLS][SEP] s1 [SEP] s2 [SEP] ...``.

    Like the reference (chaining happens after padding,
    clickstream_transformer.py:38-63), each segment's SEP sits after its
    pads.
    """
    b = padded_seqs[0].shape[0]
    cls_col = np.full((b, 1), CLS_ID, dtype=np.int32)
    sep_col = np.full((b, 1), SEP_ID, dtype=np.int32)
    parts = [cls_col, sep_col]
    for seq in padded_seqs:
        assert seq.shape[0] == b
        parts.append(seq.astype(np.int32))
        parts.append(sep_col)
    return np.concatenate(parts, axis=1)

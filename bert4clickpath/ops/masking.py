"""Padding-mask helpers.

Static-shape reworking of the reference's mask plumbing
(transformer.py:38-41): masks are additive attention biases with static
shapes, computed once per batch from the integer token ids.
"""

from __future__ import annotations

import jax.numpy as jnp

from bert4clickpath.constants import PAD_ID

# Large-negative bias added to attention logits at padded key positions.
# Finite (not -inf), as the reference's -1e9 (transformer.py:91).
NEG_INF = -1e9


def padding_bias(tokens: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(B, L) int tokens -> (B, 1, 1, L) additive attention bias.

    0 where the key position is real, ``NEG_INF`` where it is ``[PAD]``.
    Broadcasts over heads and query positions, matching the reference's
    ``create_padding_mask`` + ``mask * -1e9`` (transformer.py:38-41,91).

    A session with no real token (a row that only fills a batch) gets 0 on
    every key instead: its scores then keep their float32 resolution, so
    every attention implementation computes the same softmax and gradients
    for it. Under a -1e9 bias on every key the scores are lost in rounding,
    and a kernel that recomputes the softmax from a stored log-sum-exp
    (cuDNN's backward) gives each key probability 1 instead of 1/L.
    """
    pad = tokens == PAD_ID
    blind = pad & ~jnp.all(pad, axis=-1, keepdims=True)
    return (blind.astype(dtype) * dtype(NEG_INF))[:, None, None, :]


def valid_token_mask(tokens: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(B, L) int tokens -> (B, L) {0,1} mask of non-pad positions."""
    return (tokens != PAD_ID).astype(dtype)


def segment_ids(tokens: jnp.ndarray, sep_id: int) -> jnp.ndarray:
    """Cumulative-SEP segment markers (reference transformer.py:6-34).

    ``[CLS][SEP] s1 [SEP] s2 [SEP]`` -> ``0 1 1.. 2 2.. 3``. Kept for the
    (currently optional) segment-embedding path; the reference scaffolded but
    disabled it (transformer.py:392-395).
    """
    return jnp.cumsum((tokens == sep_id).astype(jnp.int32), axis=-1)

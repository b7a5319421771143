"""Pluggable task heads.

Position-wise heads mounted on gathered encoder outputs (reference
head.py:4-69, injected at clickstream_transformer.py:164 and called at :343).
All heads return **logits** — softmax/sigmoid folds into losses and top-k
(the reference emitted probabilities, head.py:21,45,65; fixed here).

Parameter tree of every head: ``mlp`` (``dense_<i>``, absent when
``dense_dims`` is empty) and ``out``. The tied-weight softmax head lives in
:mod:`bert4clickpath.models.model` because it shares the item embedding
table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bert4clickpath.models import layers


class MLPHead:
    """MLP -> ``output_size`` logits per position.

    * ``kind='softmax'``: MLP -> V logits (reference SoftMaxHead,
      head.py:29-47) — the "parity head": reference BERT4Rec uses dims
      [1024, 512, 256, 128] into the full catalog (source/main.py:262-263).
      :meth:`trunk` exposes everything up to (but excluding) the final
      ``out`` projection, so training can stream ``out`` through the fused
      CE (ops/fused_ce.fused_softmax_ce_bias) instead of materializing the
      (B, P, V) logits.
    * ``kind='binary'``: MLP -> one logit per position, squeezed (reference
      head.py:4-26).
    * ``kind='multilabel'``: MLP -> C independent logits (reference
      MultiLabel_MultiClass_classification, head.py:50-69; its
      squeeze(axis=1) collapsed the single-position axis — here the caller
      gathers P=1 positions and the same axis is squeezed).
    """

    def __init__(self, kind: str, dense_dims: tuple[int, ...], output_size: int, dtype):
        self.kind = kind
        self.dense_dims = tuple(dense_dims)
        self.output_size = 1 if kind == "binary" else output_size
        self.dtype = dtype

    def init_params(self, key: jax.Array, d_in: int) -> dict:
        out = {}
        if self.dense_dims:
            mk = layers.child_key(key, "mlp")
            mlp, width = {}, d_in
            for i, dim in enumerate(self.dense_dims):
                mlp[f"dense_{i}"] = layers.dense_params(
                    layers.child_key(mk, f"dense_{i}"), width, dim
                )
                width = dim
            out["mlp"] = mlp
            d_in = width
        out["out"] = layers.dense_params(
            layers.child_key(key, "out"), d_in, self.output_size
        )
        return out

    def trunk(self, p: dict, x: jnp.ndarray) -> jnp.ndarray:
        # Dense acts on the last axis only, so padded positions never
        # interact with real ones (reference head.py:15-19).
        for i in range(len(self.dense_dims)):
            x = jax.nn.relu(layers.dense(p["mlp"][f"dense_{i}"], x, self.dtype))
        return x

    def __call__(self, p: dict, x: jnp.ndarray) -> jnp.ndarray:
        logits = layers.dense(p["out"], self.trunk(p, x), self.dtype)
        if self.kind == "binary":
            return jnp.squeeze(logits, axis=-1)
        if self.kind == "multilabel" and logits.ndim == 3 and logits.shape[1] == 1:
            return jnp.squeeze(logits, axis=1)
        return logits

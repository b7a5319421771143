"""ClickstreamModel — the user-facing model facade.

Plain-JAX replacement for the reference ``ClickstreamTransformer``
(clickstream_transformer.py:106-382). Differences by design (SURVEY.md §7):

* Inputs are **integer ids** with static shapes. String->id lookup happens in
  the host pipeline (:mod:`bert4clickpath.vocab`); the [CLS]/[SEP]
  chaining happens in :mod:`bert4clickpath.data.chaining` at static
  offsets. Nothing ragged reaches the device.
* ``value_to_head`` routing is a fixed-width ``(B, P)`` gather of positions
  computed by the pipeline, replacing the ragged [MASK]-gather
  (clickstream_transformer.py:260-297) and with it the whole
  per-replica-pad adaptor (source/utils.py:56-113).
* ``segment_to_head`` routing is a static slice (``segment_bounds``): with
  fixed per-segment lengths the SEP positions are compile-time constants, so
  the reference's runtime SEP-scan (clickstream_transformer.py:81-94) is
  gone.
* The flagship head ties the output projection to the item embedding table
  (``tied_softmax``), which the reference never does; the reference's MLP
  softmax head remains available as the parity head.

Multi-variable events are supported exactly as in the reference: each
feature ((action, item) pairs etc.) is embedded separately and the embeddings
are concatenated on the last axis, d_model = sum of dims
(transformer.py:346-390).

Functional interface: ``model.init(rngs, features, head_positions)`` returns
``{'params': tree}``; ``model.apply(variables, *args, deterministic=...,
rngs={'dropout': key}, method=name)`` runs ``__call__`` or one of the named
stages (``encode``, ``gather_head_inputs``, ``head_trunk_outputs``,
``apply_input_proj``, ``apply_tied_transform``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from bert4clickpath.config import ModelConfig
from bert4clickpath.constants import NUM_RESERVED_TOKENS
from bert4clickpath.models import layers
from bert4clickpath.models.encoder import Encoder
from bert4clickpath.models.heads import MLPHead
from bert4clickpath.models.positional import (
    learned_positions_params,
    sinusoidal_positions,
)
from bert4clickpath.ops.masking import padding_bias
from bert4clickpath.utils.device import compute_dtype

_APPLY_METHODS = (
    "__call__",
    "encode",
    "gather_head_inputs",
    "head_trunk_outputs",
    "apply_input_proj",
    "apply_tied_transform",
)


class ClickstreamModel:
    def __init__(self, config: ModelConfig, remat: bool = False):
        self.config = config
        self.remat = remat
        self._dtype = compute_dtype(config)
        self.encoder = Encoder(
            num_layers=config.num_layers,
            d_model=config.d_model,
            num_heads=config.num_heads,
            ffn_dim=config.ffn_dim,
            dropout_rate=config.dropout_rate,
            dtype=self._dtype,
            remat=remat,
            qkv_fused=config.qkv_fused,
            norm_style=config.norm_style,
        )
        head = config.head
        self.head = (
            None
            if head.kind == "tied_softmax"
            else MLPHead(head.kind, head.dense_dims, head.output_size, self._dtype)
        )

    # -- parameters ----------------------------------------------------------

    def _has_input_proj(self) -> bool:
        cfg = self.config
        embed_sum = sum(fc.embedding_dim for fc in cfg.features.values())
        # ALBERT-style factorized input (config.encoder_dim)
        return bool(cfg.encoder_dim) and cfg.encoder_dim != embed_sum

    def _tied_width(self) -> int:
        cfg = self.config
        return cfg.head.dense_dims[-1] if cfg.head.dense_dims else cfg.d_model

    def init(self, rngs, *args, **kwargs) -> dict:
        """``{'params': tree}`` for this config. ``rngs`` is a PRNG key or
        ``{'params': key}``; example inputs may be passed for symmetry with
        :meth:`apply` but shapes come from the config alone."""
        del args, kwargs
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        cfg, k, d = self.config, layers.child_key, self.config.d_model
        p = {
            f"embed_{name}": layers.embed_params(
                k(key, f"embed_{name}"), fc.vocab_rows, fc.embedding_dim
            )
            for name, fc in cfg.features.items()
        }
        if self._has_input_proj():
            embed_sum = sum(fc.embedding_dim for fc in cfg.features.values())
            p["input_proj"] = layers.dense_params(k(key, "input_proj"), embed_sum, d)
        if cfg.positional == "learned":
            p["positions"] = learned_positions_params(k(key, "positions"), cfg.max_len, d)
        if cfg.use_segment_embeddings:
            p["segment_embed"] = layers.embed_params(
                k(key, "segment_embed"), cfg.max_segments, d
            )
        p["encoder"] = self.encoder.init_params(k(key, "encoder"))
        head = cfg.head
        if self.head is not None:
            p["head"] = self.head.init_params(k(key, "head"), d)
            return {"params": p}
        # tied_softmax: optional BERT-MLM-style transform before the tied
        # projection (head.dense_dims -> Dense+gelu stack + LayerNorm), a
        # width-matching projection, and an optional free per-item bias
        width = d
        for i, dim in enumerate(head.dense_dims):
            name = f"tied_transform_{i}"
            p[name] = layers.dense_params(k(key, name), width, dim)
            width = dim
        if head.dense_dims:
            p["tied_transform_ln"] = layers.layer_norm_params(width)
        d_item = cfg.features[cfg.item_feature].embedding_dim
        if width != d_item:
            # down/up-project to the item embedding width before tying
            p["tied_proj"] = layers.dense_params(k(key, "tied_proj"), width, d_item)
        if head.tied_bias:
            v = head.output_size or (
                cfg.features[cfg.item_feature].vocab_rows - NUM_RESERVED_TOKENS - 1
            )
            p["tied_out_bias"] = jnp.zeros((v,), jnp.float32)
        return {"params": p}

    def apply(self, variables: dict, *args, rngs=None, method: Optional[str] = None, **kwargs):
        """Run ``method`` (default ``__call__``) on ``variables['params']``;
        ``rngs={'dropout': key}`` feeds dropout when ``deterministic=False``."""
        name = method or "__call__"
        if name not in _APPLY_METHODS:
            raise ValueError(f"unknown method {name!r}; expected one of {_APPLY_METHODS}")
        rng = None if rngs is None else rngs.get("dropout")
        fn = self._call if name == "__call__" else getattr(self, "_" + name)
        return fn(variables["params"], *args, rng=rng, **kwargs)

    # -- forward stages ------------------------------------------------------

    def _encode(
        self, p: dict, features: dict[str, jnp.ndarray], deterministic: bool = True, rng=None
    ) -> jnp.ndarray:
        """dict of (B, L) int32 -> (B, L, d_model) contextual embeddings."""
        cfg = self.config
        names = list(cfg.features.keys())
        first = features[names[0]]
        bias = padding_bias(first, jnp.float32)
        seq_len = first.shape[1]
        if cfg.positional == "learned":
            pos = p["positions"]["embedding"][:seq_len]
        else:
            pos = jnp.asarray(sinusoidal_positions(cfg.max_len, cfg.d_model))[:seq_len]
        # Per-feature embed, concat on the embedding axis (multi-variable
        # events; reference transformer.py:384-388).
        embedded = jnp.concatenate(
            [
                jnp.take(p[f"embed_{n}"]["embedding"], features[n], axis=0).astype(self._dtype)
                for n in names
            ],
            axis=-1,
        )
        # ×√(embedding width), BEFORE any factorized up-projection: the
        # reference's ×√d_model (transformer.py:390) normalizes its
        # 1/√d-initialized table to unit scale; applying √d_model after a
        # narrower table + lecun-init projection would enter the encoder
        # √(d_model/d_embed)× too hot (and amplify the table's input-side
        # grads by the same factor vs its tied output-side grads).
        embedded = embedded * jnp.sqrt(jnp.asarray(embedded.shape[-1], self._dtype))
        embedded = self._apply_input_proj(p, embedded)
        embedded = embedded + pos.astype(self._dtype)[None]
        if cfg.use_segment_embeddings:
            # cumulative-SEP markers: [CLS][SEP] s1 [SEP] s2 -> 0 1.. 2..
            from bert4clickpath.constants import SEP_ID
            from bert4clickpath.ops.masking import segment_ids

            seg = jnp.clip(segment_ids(first, SEP_ID), 0, cfg.max_segments - 1)
            embedded = embedded + jnp.take(
                p["segment_embed"]["embedding"], seg, axis=0
            ).astype(self._dtype)
        return self.encoder.apply(
            {"params": p["encoder"]}, embedded, bias, deterministic,
            rngs=None if rng is None else {"dropout": rng},
        )

    def _apply_input_proj(self, p: dict, x: jnp.ndarray, rng=None) -> jnp.ndarray:
        """Factorized-input up-projection (identity unless ``encoder_dim`` is
        set and differs from the concatenated embedding width)."""
        if "input_proj" in p:
            return layers.dense(p["input_proj"], x, self._dtype)
        return x

    def _apply_tied_transform(self, p: dict, x: jnp.ndarray, rng=None) -> jnp.ndarray:
        """BERT-MLM-style pre-projection for the tied head: Dense+gelu per
        configured dim then LayerNorm (identity when dense_dims is empty),
        plus the width-matching projection to the item embedding dim. Output
        is ready for ``x @ E^T``."""
        cfg = self.config
        if cfg.head.kind != "tied_softmax":
            return x
        if cfg.head.dense_dims:
            x = x.astype(self._dtype)
            for i in range(len(cfg.head.dense_dims)):
                x = jax.nn.gelu(layers.dense(p[f"tied_transform_{i}"], x, self._dtype))
            x = layers.layer_norm(p["tied_transform_ln"], x, self._dtype)
        if "tied_proj" in p:
            x = layers.dense(p["tied_proj"], x, self._dtype)
        return x

    def _route(
        self, h: jnp.ndarray, head_positions: Optional[jnp.ndarray]
    ) -> jnp.ndarray:
        """Gather the head's input positions from the encoder output."""
        cfg = self.config
        if cfg.routing == "mask":
            if head_positions is None:
                raise ValueError("routing='mask' requires head_positions")
            return jnp.take_along_axis(
                h, head_positions[..., None].astype(jnp.int32), axis=1
            )
        start, end = cfg.segment_bounds
        return h[:, start:end]

    def _gather_head_inputs(
        self,
        p: dict,
        features: dict[str, jnp.ndarray],
        head_positions: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        rng=None,
    ) -> jnp.ndarray:
        """Encode, gather the routed positions, and (for tied heads) apply
        the pre-projection transform — everything EXCEPT the final catalog
        projection.

        (B, P, d_head) f32 — the input the fused tied-projection CE consumes
        (ops/fused_ce.py), so the (B, P, V) logits never materialize.
        """
        h = self._encode(p, features, deterministic, rng)
        gathered = self._route(h, head_positions)
        return self._apply_tied_transform(p, gathered).astype(jnp.float32)

    def _head_trunk_outputs(
        self,
        p: dict,
        features: dict[str, jnp.ndarray],
        head_positions: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        rng=None,
    ) -> jnp.ndarray:
        """Encode, gather, and run the softmax head's MLP trunk — every
        layer EXCEPT the final ``Dense(V)`` catalog projection.

        (B, P, d_trunk) f32 — the fused-CE input for the ``softmax``
        (reference parity MLP) head; the counterpart of
        ``gather_head_inputs`` for tied heads. The final projection's
        kernel/bias feed ``fused_softmax_ce_bias`` directly, so the
        (B, P, V) logits never materialize.
        """
        if self.config.head.kind != "softmax":
            raise ValueError("head_trunk_outputs requires head kind 'softmax'")
        h = self._encode(p, features, deterministic, rng)
        gathered = self._route(h, head_positions)
        return self.head.trunk(p["head"], gathered).astype(jnp.float32)

    def _call(
        self,
        p: dict,
        features: dict[str, jnp.ndarray],
        head_positions: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        rng=None,
    ) -> jnp.ndarray:
        """Forward to head logits.

        features: {name: (B, L) int32 model-space ids}
        head_positions: (B, P) int32 token indices for routing='mask'
            (positions of [MASK] tokens, 0-padded; pad rows are ignored
            downstream because their labels are LABEL_PAD).
        Returns (B, P, V) logits for softmax heads, (B, P) for binary.
        """
        h = self._encode(p, features, deterministic, rng)
        gathered = self._route(h, head_positions)  # (B, P, d_model)
        if self.head is None:
            return self._tied_logits(p, gathered)
        return self.head(p["head"], gathered)

    def _tied_logits(self, p: dict, x: jnp.ndarray) -> jnp.ndarray:
        """Tied-weight output projection over the raw-vocab rows.

        logits = x @ E_items[10:10+V]^T, sharing the item embedding table
        (BASELINE.json north star; enables vocab-sharded CE under the model
        mesh axis).

        V comes from ``head.output_size`` when set — required whenever the
        table rows were padded (padded_vocab_rows), otherwise untrained
        OOV/padding rows would be rankable. The fallback (rows - reserved -
        1 OOV) is only right for unpadded tables.
        """
        cfg = self.config
        x = self._apply_tied_transform(p, x)
        table = p[f"embed_{cfg.item_feature}"]["embedding"]  # (rows, D_item)
        v = cfg.head.output_size or (table.shape[0] - NUM_RESERVED_TOKENS - 1)
        weights = table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + v]
        logits = jnp.einsum(
            "bpd,vd->bpv",
            x,
            weights.astype(self._dtype),
            preferred_element_type=jnp.float32,
        )
        if cfg.head.tied_bias:
            logits = logits + p["tied_out_bias"]
        return logits


def tied_bias_model_space(bias: jnp.ndarray, rows: int) -> jnp.ndarray:
    """(rows,) model-space bias: the (V_label,) ``tied_out_bias`` placed at
    the reserved-token offset; reserved/OOV/padding rows stay 0 (those rows
    are blinded by every consumer anyway)."""
    return jax.lax.dynamic_update_slice(
        jnp.zeros((rows,), bias.dtype), bias, (NUM_RESERVED_TOKENS,)
    )


def head_catalog(config: ModelConfig, params, pad_rows: bool = False):
    """The catalog a softmax-family head ranks: (table, bias, row_offset,
    base_rows).

    tied_softmax: the (rows, D_item) item embedding table with
    ``tied_out_bias`` (if any) spread via :func:`tied_bias_model_space`;
    row_offset = NUM_RESERVED_TOKENS. softmax (the reference's MLP head):
    the final Dense(V) kernel transposed to (V, d_trunk) rows + its bias,
    row_offset 0 — always padded to the fused-CE/chunked-eval tile
    (``ops.fused_ce.padded_rows``). ``pad_rows=True`` pads a tied
    table too (serving can't assume the training driver pre-padded
    vocab_rows). ``base_rows`` is the pre-padding row count, for deriving
    num_valid.

    Shared by the fused-CE train loss, the chunked eval step, and serving —
    one place owns the params-tree paths and the padding arithmetic.
    """
    from bert4clickpath.ops.fused_ce import padded_rows

    p = params["params"] if "params" in params else params
    kind = config.head.kind
    if kind == "tied_softmax":
        table = p[f"embed_{config.item_feature}"]["embedding"]
        base_rows = table.shape[0]
        bias = (
            tied_bias_model_space(p["tied_out_bias"], base_rows)
            if config.head.tied_bias
            else None
        )
        if pad_rows:
            pad = padded_rows(base_rows) - base_rows
            if pad:
                table = jnp.pad(table, ((0, pad), (0, 0)))
                bias = None if bias is None else jnp.pad(bias, (0, pad))
        return table, bias, NUM_RESERVED_TOKENS, base_rows
    if kind == "softmax":
        wk = p["head"]["out"]["kernel"]  # (d_trunk, V)
        bk = p["head"]["out"]["bias"]  # (V,)
        v = wk.shape[1]
        pad = padded_rows(v) - v
        return jnp.pad(wk.T, ((0, pad), (0, 0))), jnp.pad(bk, (0, pad)), 0, v
    raise ValueError(f"softmax-family head required, got {kind!r}")

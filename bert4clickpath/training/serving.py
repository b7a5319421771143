"""String-in serving shim over an exported bundle.

The reference's headline serving property — "strings in, scores out, vocab
travels with the model" (SavedModel export, clickstream_transformer.py:354-375
+ training_utils.py:68-74) — preserved without string ops on the device:
the exported bundle (:func:`bert4clickpath.training.checkpoint.export_serving`) carries
params + ModelConfig + vocab artifacts, and this shim does the tiny host-side
string->id step before a jitted forward.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath.config import ModelConfig
from bert4clickpath.data.cloze import ITEM_OFFSET, token_length
from bert4clickpath.constants import CLS_ID, MASK_ID, NA_ID, PAD_ID, SEP_ID
from bert4clickpath.models.model import ClickstreamModel
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.vocab import Vocabulary


def _bucket(b: int) -> int:
    """Next power-of-two batch bucket (min 1) so request sizes map onto a
    small, reused set of compiled shapes."""
    out = 1
    while out < b:
        out *= 2
    return out


class ServingModel:
    """Load an exported bundle and score item sequences from raw strings.

    ``warmup_batches``: compile the scoring program for these client batch
    sizes at load time (each is rounded up to its power-of-two bucket).
    Without it the first request at each bucket pays a full XLA compile
    (~seconds).
    ``warmup_k``: the k value(s) to warm — k is static under jit, so warm
    every k you plan to serve (int or sequence of ints).
    """

    def __init__(
        self,
        export_dir: str,
        warmup_batches: Sequence[int] = (),
        warmup_k=10,
    ):
        export_dir = os.path.abspath(export_dir)
        with open(os.path.join(export_dir, "model_config.json")) as f:
            self.config = ModelConfig.from_json(f.read())
        with open(os.path.join(export_dir, "MANIFEST.json")) as f:
            manifest = json.load(f)
        self.vocabs = {
            name: Vocabulary.load_artifact(export_dir, name)
            for name in manifest["vocabs"]
        }
        self.model = ClickstreamModel(self.config)
        # Build abstract params by tracing init, then restore real values.
        feature = next(iter(self.config.features))
        dummy_feats = {
            n: jnp.zeros((1, self.config.max_len), jnp.int32)
            for n in self.config.features
        }
        dummy_pos = jnp.zeros((1, self.config.head_width), jnp.int32)
        abstract = jax.eval_shape(
            lambda: self.model.init(jax.random.PRNGKey(0), dummy_feats, dummy_pos)
        )
        # restore_params returns HOST numpy arrays; pin them on device once.
        # Left on host, jit re-uploads the full param tree (~80 MB for the
        # flagship MLP head) with every request.
        self.params = jax.device_put(
            ckpt_lib.restore_params(os.path.join(export_dir, "params"), abstract)
        )
        # the catalog feature the head ranks; other features are paired
        # per-event context (multi-variable models, e.g. (action, item))
        self._item_feature = (
            self.config.item_feature
            if self.config.item_feature in self.config.features
            else feature
        )
        if self.config.head.kind not in ("tied_softmax", "softmax"):
            raise ValueError(
                "ServingModel.recommend ranks the item catalog; head kind "
                f"{self.config.head.kind!r} has no catalog to rank"
            )
        # catalog prep (transpose + tile padding) runs ONCE at load — inside
        # the jitted fn it would re-run per request (params are runtime jit
        # inputs, so XLA can't constant-fold the pad: ~56 MB/request at the
        # flagship MLP export, multi-GB at 10M-item tied catalogs)
        from bert4clickpath.models.model import head_catalog

        table, bias, _, base_rows = head_catalog(
            self.config, self.params, pad_rows=True
        )
        self._catalog = (jnp.asarray(table), None if bias is None else jnp.asarray(bias))
        self._catalog_base_rows = base_rows
        self._topk = jax.jit(self._make_topk(), static_argnums=(5,))
        if warmup_batches:
            self.warmup(warmup_batches, k=warmup_k)

    def warmup(self, batch_sizes: Sequence[int], k=10) -> None:
        """Pre-compile the scoring program for each (batch bucket, k) by
        scoring all-empty sessions (the pad-row construction recommend()
        already uses), so live requests at those shapes never hit a cold
        XLA compile. ``k`` is a static jit argument — a request with a k
        you did not warm still compiles on first use, so pass every k you
        serve (int or sequence)."""
        ks = (k,) if isinstance(k, int) else tuple(k)
        # multi-variable models take dict sessions (recommend()'s contract)
        names = list(self.config.features)
        empty = [] if len(names) == 1 else {f: [] for f in names}
        for bs in sorted({_bucket(b) for b in batch_sizes}):
            for kk in ks:
                self.recommend([empty] * bs, k=kk)

    def _make_topk(self):
        """(params, table, bias, feats, (B,1) positions, k) ->
        (logprobs (B,k), label ids).

        Scores via the chunked catalog scan (ops/chunked_eval.chunked_scores)
        on the single [MASK] position: no (B, P, V) logits, so serving works
        unchanged at 10M-item catalogs, and the softmax normalizer comes
        from the scan's online logsumexp. ``table``/``bias`` are the
        load-time prepared catalog (self._catalog), passed as arguments so
        they live on device once rather than being rebuilt per request.
        """
        from bert4clickpath.constants import (
            LABEL_PAD,
            NUM_RESERVED_TOKENS,
        )
        from bert4clickpath.ops.chunked_eval import chunked_scores, pick_chunk

        cfg = self.config
        model = self.model
        if cfg.head.kind == "tied_softmax":
            row_offset = NUM_RESERVED_TOKENS
            v_label = cfg.head.output_size or (
                self._catalog_base_rows - NUM_RESERVED_TOKENS - 1
            )
        else:  # 'softmax' MLP head: final Dense(V) rows as the catalog
            row_offset = 0
            v_label = self._catalog_base_rows

        def fn(params, table, bias, feats, pos, k):
            x = model.apply(
                params, feats, pos, deterministic=True,
                method=(
                    "gather_head_inputs"
                    if cfg.head.kind == "tied_softmax"
                    else "head_trunk_outputs"
                ),
            )
            no_labels = jnp.full(x.shape[:2], LABEL_PAD, jnp.int32)
            logz, _, vals, rowids = chunked_scores(
                x, table, no_labels, k,
                row_offset=row_offset, num_valid=v_label,
                chunk=pick_chunk(table.shape[0], rows=x.shape[0] * x.shape[1]), bias=bias,
            )
            logprobs = vals[:, 0] - logz[:, 0, None]  # (B, k)
            return logprobs, rowids[:, 0] - row_offset  # label-space ids

        return fn

    def encode(self, sessions):
        """Sessions -> (features {name: (B', L) int32}, positions (B', 1))
        on device, B' the power-of-two bucket of len(sessions): each session
        truncated to the most recent window, a [MASK] slot appended, and
        the batch padded with inert all-PAD rows."""
        cfg = self.config
        names = list(cfg.features)
        max_items = cfg.max_len - 3  # [CLS][SEP] ... [SEP]
        b = len(sessions)

        # normalize: single-feature models take each session as a token
        # list; multi-variable models take {feature: [tokens...]} per
        # session with aligned per-event lists (the training convention:
        # examples/bert4rec/multivariable.py)
        if b and isinstance(sessions[0], dict):
            per_feature = {}
            for f in names:
                try:
                    per_feature[f] = [s[f] for s in sessions]
                except KeyError:
                    raise ValueError(f"session missing feature {f!r}")
        elif len(names) > 1:
            raise ValueError(
                f"model has features {names}; pass each session as a dict "
                "{feature: [tokens...]} with aligned lengths"
            )
        else:
            per_feature = {self._item_feature: sessions}
        lens = [len(s) for s in per_feature[self._item_feature]]
        for f in names:
            for i, s in enumerate(per_feature[f]):
                if len(s) != lens[i]:
                    raise ValueError(
                        f"session {i}: feature {f!r} has {len(s)} events, "
                        f"{self._item_feature!r} has {lens[i]}"
                    )

        # bucket the batch dimension so arbitrary request sizes reuse a
        # handful of compiled programs (static shapes: every distinct B
        # would otherwise trigger a fresh XLA compile); padded rows are
        # all-PAD sessions whose results are sliced off below
        bp = _bucket(b)
        positions = np.zeros((bp, 1), np.int32)  # only the [MASK] slot scores
        positions[:, 0] = ITEM_OFFSET  # pad rows: score the (inert) slot 2
        feats = {}
        for f in names:
            vf = self.vocabs[f]
            tokens = np.full((bp, token_length(max_items)), PAD_ID, np.int32)
            tokens[:, 0] = CLS_ID
            tokens[:, 1] = SEP_ID
            tokens[:, -1] = SEP_ID
            for i, session in enumerate(per_feature[f]):
                # truncate all features to the same most-recent window
                ids = vf.encode_model(list(session))[-(max_items - 1):]
                n = len(ids)
                tokens[i, ITEM_OFFSET : ITEM_OFFSET + n] = ids
                # the appended next-item slot: [MASK] on the item feature,
                # [NA] on paired features (the model never reads a real
                # event at a masked slot — multivariable.py:59-93)
                tokens[i, ITEM_OFFSET + n] = (
                    MASK_ID if f == self._item_feature else NA_ID
                )
                positions[i, 0] = ITEM_OFFSET + n
            feats[f] = jnp.asarray(tokens)
        return feats, jnp.asarray(positions)

    def recommend(
        self,
        sessions: Sequence[Sequence[str]],
        k: int = 10,
        instance_ids: Optional[Sequence[str]] = None,
    ) -> list:
        """Next-item recommendation: append a [MASK] slot after each session
        and rank the full catalog for it. Returns per-session top-k
        (item, score) with scores as softmax log-probabilities.

        instance_ids: optional opaque request ids passed through with each
        result (the reference's serving contract,
        clickstream_transformer.py:346-350) — output becomes
        ``[{"instance_id": ..., "items": [(item, score), ...]}, ...]``.
        """
        if instance_ids is not None and len(instance_ids) != len(sessions):
            raise ValueError(
                f"{len(instance_ids)} instance_ids for {len(sessions)} sessions"
            )
        b = len(sessions)
        if b == 0:
            return []
        vocab = self.vocabs[self._item_feature]
        feats, positions = self.encode(sessions)
        table, bias = self._catalog
        scores, idx = self._topk(self.params, table, bias, feats, positions, k)
        scores, idx = np.asarray(scores)[:b], np.asarray(idx)[:b]
        results = [
            [(vocab.decode_label(int(idx[i, j])), float(scores[i, j])) for j in range(k)]
            for i in range(b)
        ]
        if instance_ids is not None:
            return [
                {"instance_id": iid, "items": items}
                for iid, items in zip(instance_ids, results)
            ]
        return results

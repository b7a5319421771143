"""Dataclass configuration for models, training, and the device mesh.

Replaces the reference's three loose ctor dicts
(``sequential_input_config`` / ``feature_vocabs`` / ``embedding_dims``,
clickstream_transformer.py:160-227) and its spec-dict argparse generator
(source/utils.py:7-53) with typed configs that serialize to JSON so they can
travel with checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

from bert4clickpath.constants import MAX_MASKED_ITEMS


@dataclass(frozen=True)
class FeatureConfig:
    """One embedded sequential feature (e.g. items, actions).

    vocab_rows counts *model-space* rows: reserved + raw vocab + OOV bucket
    (see :class:`bert4clickpath.vocab.Vocabulary.model_vocab_size`).
    """

    vocab_rows: int
    embedding_dim: int


@dataclass(frozen=True)
class HeadConfig:
    """A pluggable task head mounted on gathered encoder outputs.

    kind:
      * ``softmax`` — MLP -> V logits; the reference "parity head"
        (head.py:29-47 + source/main.py:262, dims [1024,512,256,128]).
      * ``tied_softmax`` — logits = x @ E_items^T over the raw-vocab rows of
        the item embedding table; the flagship default (ties weights,
        enables vocab-sharded loss).
      * ``binary`` — MLP -> scalar logit per position (head.py:4-26).
      * ``multilabel`` — MLP -> C independent logits (head.py:50-69).

    All heads emit **logits**; activations fold into losses/metrics. The
    reference emitted probabilities (head.py:21,45,65) which is numerically
    inferior — intentionally not replicated.
    """

    kind: str = "softmax"
    dense_dims: tuple[int, ...] = ()
    output_size: int = 0  # V for softmax/multilabel; ignored for binary/tied
    # tied_softmax only: add a free per-item output bias (BERT's MLM decoder
    # ties weights but keeps its own bias). Lets popularity live in the bias
    # instead of distorting embedding norms. Supported on every path: dense
    # logits, fused CE (its kernels take a per-row bias input), the sharded
    # fused CE, chunked eval, and serving.
    tied_bias: bool = False

    def __post_init__(self):
        if self.kind not in ("softmax", "tied_softmax", "binary", "multilabel"):
            raise ValueError(f"unknown head kind {self.kind!r}")
        if self.tied_bias and self.kind != "tied_softmax":
            raise ValueError("tied_bias requires kind='tied_softmax'")


@dataclass(frozen=True)
class ModelConfig:
    """Encoder + head + routing.

    Routing (reference clickstream_transformer.py:317-341): exactly one of

    * ``routing='mask'`` — gather encoder outputs at fixed-width
      ``(B, max_masked)`` positions supplied by the pipeline. Replaces the
      reference's ragged ``[MASK]``-position gather
      (clickstream_transformer.py:260-297) with static shapes.
    * ``routing='segment'`` — slice a static ``[start, end)`` token range of
      the chained sequence (e.g. the CLS summary, or a basket segment). With
      fixed per-segment lengths the offsets are static, deleting the
      reference's runtime SEP-scan (clickstream_transformer.py:81-94).
    """

    features: dict[str, FeatureConfig] = field(default_factory=dict)
    num_layers: int = 2
    num_heads: int = 2
    ffn_dim: int = 100  # reference hard-codes 100 (clickstream_transformer.py:225)
    dropout_rate: float = 0.1
    max_len: int = 53  # tokens incl. [CLS][SEP]...[SEP]
    positional: str = "sinusoidal"  # or "learned" (BERT4Rec-style)
    head: HeadConfig = field(default_factory=HeadConfig)
    routing: str = "mask"
    segment_bounds: Optional[tuple[int, int]] = None  # for routing='segment'
    max_masked: int = MAX_MASKED_ITEMS  # P, width of the head gather
    # Segment embeddings over cumulative-SEP markers: the reference scaffolded
    # but disabled these (transformer.py:358,392-395); useful with chained
    # multi-sequence inputs (routing='segment').
    use_segment_embeddings: bool = False
    max_segments: int = 8
    dtype: str = "float32"  # computation dtype: "bfloat16" on the GPU
    # Residual/LayerNorm order: "post" = the reference's post-LN blocks
    # (transformer.py:202-213); "pre" = pre-LN (normalize sublayer inputs,
    # final LN after the stack) — unlocks depth: post-LN 6L collapses on
    # Beauty under every measured LR (BASELINE.md round 4).
    norm_style: str = "post"
    # name of the feature whose embedding the tied head shares
    item_feature: str = "items"
    # ALBERT-style factorized input: when > 0 and different from the sum of
    # embedding dims, a Dense projects the concatenated embeddings up to this
    # encoder width. Decouples table capacity (the overfitting lever on small
    # catalogs — the table is ~80% of flagship params) from encoder width;
    # the tied head's width-matching projection maps back to table space.
    encoder_dim: int = 0
    # Fused (D, 3D) QKV projection: one matmul instead of three D-wide ones
    # per attention block. Changes the parameter tree (wqkv replaces wq/wk/wv), so
    # it is an architecture field, not an impl switch. Not supported by the
    # tensor-parallel tier (its column-split specs are per-projection).
    qkv_fused: bool = False

    def __post_init__(self):
        if self.routing not in ("mask", "segment"):
            raise ValueError(f"unknown routing {self.routing!r}")
        if self.routing == "segment" and self.segment_bounds is None:
            raise ValueError("routing='segment' requires segment_bounds")
        if self.positional not in ("sinusoidal", "learned"):
            raise ValueError(f"unknown positional {self.positional!r}")
        if self.norm_style not in ("post", "pre"):
            raise ValueError(f"unknown norm_style {self.norm_style!r}")

    @property
    def d_model(self) -> int:
        """Encoder width: ``encoder_dim`` if set, else the sum of per-feature
        embedding dims (reference transformer.py:336)."""
        return self.encoder_dim or sum(
            f.embedding_dim for f in self.features.values()
        )

    @property
    def head_width(self) -> int:
        """P — number of positions fed to the head."""
        if self.routing == "mask":
            return self.max_masked
        start, end = self.segment_bounds
        return end - start

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            return o

        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, payload: str) -> "ModelConfig":
        d = json.loads(payload)
        d["features"] = {k: FeatureConfig(**v) for k, v in d["features"].items()}
        # pass every field through so new HeadConfig fields (tied_bias, ...)
        # survive the round-trip instead of silently reverting to defaults
        d["head"] = HeadConfig(
            **{**d["head"], "dense_dims": tuple(d["head"]["dense_dims"])}
        )
        if d.get("segment_bounds") is not None:
            d["segment_bounds"] = tuple(d["segment_bounds"])
        return cls(**d)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop parameters (reference source/main.py:186-211)."""

    batch_size: int = 100  # global batch
    eval_batch_size: int = 0  # 0 -> use batch_size
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-9
    lr_schedule: str = "constant"  # constant | rsqrt_warmup | exp_decay
    warmup_steps: int = 4000
    n_epochs: int = 10000
    steps_per_epoch: int = 100
    validation_steps: int = 0  # 0 -> full eval pass
    # Evaluate every N epochs (plateau/early-stop counters advance only on
    # evaluated epochs). A full-catalog eval pass can cost several train
    # epochs, so metric runs often want 2-5 here.
    eval_every: int = 1
    early_stopping_patience: int = 30  # epochs (reference main.py:156)
    plateau_patience: int = 10  # epochs (reference main.py:134)
    plateau_factor: float = 0.317
    # What drives best-ckpt / plateau / early-stop. The reference monitored
    # val_loss (main.py:134,141,156), but full-softmax CE diverges while
    # ranking metrics still improve (BASELINE.md: val_loss monitoring
    # early-stops Beauty at ~0.02 recall@10 vs 0.036 NDCG-monitored).
    # "auto" = val_ndcg@10 when the head emits it, else val_loss.
    monitor: str = "auto"
    monitor_mode: str = "auto"  # resolved with "auto"; else "min" | "max"
    seed: int = 0
    log_every: int = 50  # steps
    remat: bool = False  # jax.checkpoint the encoder layers
    # Retain at most N best-so-far checkpoints under model_dir/ckpts
    # (0 = keep all, the reference's timestamped-ModelCheckpoint
    # accumulation, source/main.py:137-142 — ~10 GB per Beauty run).
    ckpt_keep: int = 0
    # EMA of params for eval/export (0 disables). Polyak averaging is a
    # standard production-recsys quality lever the reference lacks; the
    # shadow is updated in the train step and ranked/exported instead of
    # the raw params (training/train_state.py:eval_params).
    ema_decay: float = 0.0

    def __post_init__(self):
        if self.monitor == "auto" and self.monitor_mode != "auto":
            # with monitor unresolved, a pinned mode can invert best-model
            # selection (e.g. mode='min' while auto picks val_ndcg@10 —
            # the trainer would track the WORST epoch); reject the combo
            raise ValueError(
                "monitor='auto' requires monitor_mode='auto' — pin the "
                "monitor metric when pinning its mode"
            )
        if self.monitor_mode not in ("auto", "min", "max"):
            raise ValueError(f"monitor_mode {self.monitor_mode!r}")


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: data-parallel x model(vocab-shard) axes.

    Replaces the reference's MirroredStrategy (source/main.py:46-57) with an
    explicit ``jax.sharding.Mesh``; collectives are psum/all_gather.
    """

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model

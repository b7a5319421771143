"""Tier × feature support matrix — the single source of truth.

Each parallel tier composes with a subset of (head kind, qkv_fused,
sampled softmax). Historically every
exclusion lived in its own constructor (tp.py:_check_tp_supported,
spmd.py:_check_spmd_supported, driver SystemExits) and was discoverable
only by hitting the error. This module centralizes the rules so that

* every tier constructor validates the SAME table up front,
* the training driver can reject an unsupported combination before
  building anything, and
* :func:`render_matrix` emits the markdown table published in
  COMPONENTS.md (a test regenerates it, so the doc cannot go stale).

No reference equivalent: the reference has one tier (MirroredStrategy,
examples/BERT4Rec/source/main.py:46-57) and one head wiring per script,
so it never needed a compatibility contract.
"""

from __future__ import annotations

from typing import Optional

TIERS = ("single", "dp", "spmd", "tp", "tp_spmd", "sampled_spmd")
HEAD_KINDS = ("tied_softmax", "softmax", "binary", "multilabel")

# Why-strings double as error messages and matrix footnotes.
_R_SPMD_HEAD = (
    "the vocab-sharded SPMD tier requires the tied head (the projection "
    "shards with the table); MLP-softmax/binary/multilabel heads use the "
    "pure data-parallel tier"
)
_R_TP_QKV = (
    "tensor-parallel column splits are per-projection (wq/wk/wv); the fused "
    "(D, 3D) kernel's q|k|v blocks do not align with contiguous shards"
)
_R_SAMPLED_HEAD = "sampled softmax requires a softmax-family head"
_R_SAMPLED_DP = (
    "the DP tier reduces exact fused-CE sums; run sampled softmax "
    "single-device or via the sampled_spmd pjit tier"
)
_R_SAMPLED_SPMD = (
    "the vocab-sharded fused-CE tier computes the exact partition function; "
    "for sampled softmax over a sharded table use sampled_spmd"
)
_R_SAMPLED_TP = (
    "sampled softmax + tensor parallelism is an unvalidated composition; "
    "run sampled softmax via sampled_spmd (table sharding) instead"
)
_R_SSPMD_SAMPLES = "the sampled_spmd tier IS the sampled-softmax path (pass num_samples > 0)"

# rules[tier][feature] -> None (supported) | reason string (rejected).
# Features: per head kind, qkv_fused, sampled.
_OK = None
RULES: dict[str, dict[str, Optional[str]]] = {
    "single": {},  # everything composes on one chip
    "dp": {"sampled": _R_SAMPLED_DP},
    "spmd": {
        "head:softmax": _R_SPMD_HEAD,
        "head:binary": _R_SPMD_HEAD,
        "head:multilabel": _R_SPMD_HEAD,
        "sampled": _R_SAMPLED_SPMD,
    },
    "tp": {
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_TP,
    },
    "tp_spmd": {
        "head:softmax": _R_SPMD_HEAD,
        "head:binary": _R_SPMD_HEAD,
        "head:multilabel": _R_SPMD_HEAD,
        "qkv_fused": _R_TP_QKV,
        "sampled": _R_SAMPLED_SPMD,
    },
    "sampled_spmd": {
        "head:binary": _R_SAMPLED_HEAD,
        "head:multilabel": _R_SAMPLED_HEAD,
        "no_sampled": _R_SSPMD_SAMPLES,
    },
}
# sampled softmax additionally requires a softmax-family head on EVERY tier
for _t in TIERS:
    RULES[_t].setdefault("sampled+head:binary", _R_SAMPLED_HEAD)
    RULES[_t].setdefault("sampled+head:multilabel", _R_SAMPLED_HEAD)


def validate_tier(
    tier: str,
    head_kind: str,
    *,
    qkv_fused: bool = False,
    sampled: int = 0,
) -> None:
    """Raise ValueError with the matrix reason if the combination is
    unsupported; silent when it composes. Tier constructors and the training
    driver both call this BEFORE building a step."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if head_kind not in HEAD_KINDS:
        raise ValueError(
            f"unknown head kind {head_kind!r}; expected one of {HEAD_KINDS}"
        )
    rules = RULES[tier]
    active = [f"head:{head_kind}"]
    if qkv_fused:
        active.append("qkv_fused")
    if sampled:
        active.append("sampled")
        active.append(f"sampled+head:{head_kind}")
    else:
        active.append("no_sampled")
    for feat in active:
        reason = rules.get(feat)
        if reason is not None:
            raise ValueError(f"tier {tier!r} rejects {feat!r}: {reason}")


def _cell(tier: str, feat: str) -> str:
    return "yes" if RULES[tier].get(feat) is None else "no"


def render_matrix() -> str:
    """The COMPONENTS.md support table, generated from RULES."""
    feats = [
        ("head tied_softmax", "head:tied_softmax"),
        ("head softmax (MLP)", "head:softmax"),
        ("head binary", "head:binary"),
        ("head multilabel", "head:multilabel"),
        ("qkv_fused", "qkv_fused"),
        ("sampled softmax", "sampled"),
    ]
    lines = [
        "| feature \\ tier | " + " | ".join(TIERS) + " |",
        "|---|" + "---|" * len(TIERS),
    ]
    for label, feat in feats:
        if feat == "sampled":
            # sampled_spmd REQUIRES sampling; every other tier consults the
            # 'sampled' rule
            cells = [
                "required" if t == "sampled_spmd" else _cell(t, "sampled")
                for t in TIERS
            ]
        else:
            cells = [_cell(t, feat) for t in TIERS]
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    return "\n".join(lines)

"""Performance accounting: FLOP/byte roofline estimates + profiler hooks.

The observability tier the reference left disabled (TensorBoard
profile_batch=0, source/main.py:149). Provides:

* :func:`step_cost` — analytic FLOPs + device-memory bytes for a train step
  of a given ModelConfig/batch (encoder, head/CE, optimizer);
* :func:`peaks` — the published peak rates of the device, by
  ``device_kind``;
* :func:`speed_of_light` — measured step time -> FLOP and bandwidth
  utilization against those peaks;
* :func:`trace` — context manager around ``jax.profiler`` for traces.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

from bert4clickpath.config import ModelConfig


@dataclass(frozen=True)
class Peaks:
    flops: float  # dense bf16 FLOP/s
    bytes_per_s: float  # device-memory bandwidth
    source: str


# Published peaks per ``jax.Device.device_kind`` (NVIDIA H100 data sheet,
# dense rates — the sparsity figures halved — at the card's full power
# limit). A card capped below it cannot hold the top clock under load.
PEAKS: dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(989e12, 3.35e12, "H100 SXM5 data sheet"),
    "NVIDIA H100 PCIe": Peaks(756e12, 2.0e12, "H100 PCIe data sheet"),
    "NVIDIA H100 NVL": Peaks(835e12, 3.9e12, "H100 NVL data sheet"),
}


def peaks(device_kind: str) -> Peaks:
    """Peak rates for a device kind; an unknown device is an error, never a
    guessed default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "utils/profiling.PEAKS with its source"
        ) from None


@dataclass
class StepCost:
    encoder_flops: float
    head_flops: float
    total_flops: float  # fwd + bwd
    hbm_bytes: float  # params + activations traffic estimate
    params: int

    def summary(self) -> dict:
        return {
            "encoder_gflops": round(self.encoder_flops / 1e9, 1),
            "head_gflops": round(self.head_flops / 1e9, 1),
            "total_gflops": round(self.total_flops / 1e9, 1),
            "hbm_mb": round(self.hbm_bytes / 1e6, 1),
            "params_m": round(self.params / 1e6, 2),
        }


def encoder_param_count(cfg: ModelConfig) -> int:
    d, f = cfg.d_model, cfg.ffn_dim
    per_layer = 4 * d * d + 4 * d + 2 * d * f + d + f + 4 * d  # qkv/o + ffn + 2 LN
    emb = sum(fc.vocab_rows * fc.embedding_dim for fc in cfg.features.values())
    embed_sum = sum(fc.embedding_dim for fc in cfg.features.values())
    proj = embed_sum * d + d if cfg.encoder_dim and cfg.encoder_dim != embed_sum else 0
    pos = cfg.max_len * d if cfg.positional == "learned" else 0
    return cfg.num_layers * per_layer + emb + pos + proj


def step_cost(
    cfg: ModelConfig,
    batch: int,
    label_vocab: int,
    bytes_per_param: int = 4,
    fused_ce: bool = True,
) -> StepCost:
    """Analytic cost of one training step (fwd + bwd + Adam)."""
    b, l, d, f, p = batch, cfg.max_len, cfg.d_model, cfg.ffn_dim, cfg.head_width
    # encoder fwd matmul FLOPs per layer: qkv/o (4*B*L*D^2), scores+av
    # (2*B*H*L^2*Dh = 2*B*L^2*D), ffn (2*B*L*D*F); x2 MACs->FLOPs
    per_layer = 2 * (4 * b * l * d * d + 2 * b * l * l * d + 2 * b * l * d * f)
    enc_fwd = cfg.num_layers * per_layer
    if cfg.head.kind in ("tied_softmax",):
        head_fwd = 2 * b * p * d * label_vocab
    elif cfg.head.kind == "softmax":
        dims = [d, *cfg.head.dense_dims, label_vocab]
        head_fwd = sum(2 * b * p * i * o for i, o in zip(dims[:-1], dims[1:]))
    else:
        dims = [d, *cfg.head.dense_dims, max(1, cfg.head.output_size)]
        head_fwd = sum(2 * b * p * i * o for i, o in zip(dims[:-1], dims[1:]))
    # bwd = 2x fwd; fused CE recomputes logits in bwd (+2 head_fwd passes)
    enc_total = 3 * enc_fwd
    head_total = 5 * head_fwd if fused_ce else 3 * head_fwd
    n_params = encoder_param_count(cfg)
    # HBM: params read fwd+bwd, grads written, adam mu/nu read+write (x5),
    # plus logits traffic only in the non-fused path
    hbm = n_params * bytes_per_param * 7.0
    if not fused_ce and cfg.head.kind in ("softmax", "tied_softmax"):
        hbm += 3.0 * b * p * label_vocab * 4  # materialized f32 logits fwd+bwd
    return StepCost(
        encoder_flops=enc_total,
        head_flops=head_total,
        total_flops=enc_total + head_total,
        hbm_bytes=hbm,
        params=n_params,
    )


def speed_of_light(cost: StepCost, measured_step_seconds: float, peak: Peaks) -> dict:
    """FLOP/byte roofline report for a measured step time: each bound is a
    valid lower bound on the step, so ``speed_of_light_ms`` (the larger)
    is too, and ``bound`` names which one it is."""
    flop_time = cost.total_flops / peak.flops
    hbm_time = cost.hbm_bytes / peak.bytes_per_s
    bound = "flops" if flop_time >= hbm_time else "hbm"
    sol = max(flop_time, hbm_time)
    return {
        "measured_ms": measured_step_seconds * 1e3,
        "flop_bound_ms": flop_time * 1e3,
        "hbm_bound_ms": hbm_time * 1e3,
        "speed_of_light_ms": sol * 1e3,
        "mfu": cost.total_flops / (measured_step_seconds * peak.flops),
        "sol_fraction": sol / measured_step_seconds,
        "bound": bound,
        "peaks": peak.source,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """``jax.profiler`` trace around a block (read with utils/xplane)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

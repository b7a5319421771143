"""Roofline accounting sanity checks."""

import pytest

from bert4clickpath import FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath.utils import profiling


def _cfg(head):
    return ModelConfig(
        features={"items": FeatureConfig(55296, 256)},
        num_layers=4,
        num_heads=4,
        ffn_dim=1024,
        max_len=53,
        head=head,
    )


def test_step_cost_tied_head_dominated_by_head():
    cfg = _cfg(HeadConfig("tied_softmax", output_size=54542))
    cost = profiling.step_cost(cfg, batch=256, label_vocab=54542)
    # head: 5 passes x 2*B*P*D*V = 357 GFLOP; encoder ~3x88 GFLOP
    assert cost.head_flops > cost.encoder_flops
    assert 300e9 < cost.head_flops < 400e9
    assert cost.params > 14e6  # table dominates


def test_speed_of_light_report():
    cfg = _cfg(HeadConfig("tied_softmax", output_size=54542))
    cost = profiling.step_cost(cfg, batch=256, label_vocab=54542)
    rep = profiling.speed_of_light(
        cost, measured_step_seconds=9e-3,
        peak=profiling.peaks("NVIDIA H100 80GB HBM3"),
    )
    assert rep["bound"] in ("flops", "hbm")
    assert 0 < rep["mfu"] < 1
    assert rep["speed_of_light_ms"] <= rep["measured_ms"]


def test_mlp_head_cost():
    cfg = _cfg(HeadConfig("softmax", (1024, 512, 256, 128), 54542))
    cost = profiling.step_cost(cfg, batch=256, label_vocab=54542, fused_ce=False)
    assert cost.hbm_bytes > 500e6  # materialized logits dominate


@pytest.mark.parametrize(
    "kind,flops,bw",
    [
        ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
        ("NVIDIA H100 PCIe", 756e12, 2.0e12),
        ("NVIDIA H100 NVL", 835e12, 3.9e12),
    ],
)
def test_peaks_table_by_device_kind(kind, flops, bw):
    p = profiling.peaks(kind)
    assert (p.flops, p.bytes_per_s) == (flops, bw)
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks(kind)

"""The tier × feature support matrix (parallel/support.py): one contract,
validated up front by every tier constructor and the training driver, and
published verbatim in COMPONENTS.md."""

import os
import subprocess
import sys

import pytest

from bert4clickpath.parallel.support import (
    HEAD_KINDS,
    TIERS,
    render_matrix,
    validate_tier,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_supported_combinations_pass():
    # single chip composes everything
    for head in HEAD_KINDS:
        validate_tier("single", head, qkv_fused=True)
    validate_tier("single", "tied_softmax", sampled=8192)
    # DP: every head — the MirroredStrategy-equivalent tier
    for head in HEAD_KINDS:
        validate_tier("dp", head, qkv_fused=True)
    # vocab-sharded SPMD: tied head
    validate_tier("spmd", "tied_softmax", qkv_fused=True)
    # TP: any head on the dense XLA paths
    for head in HEAD_KINDS:
        validate_tier("tp", head)
    # sampled_spmd: softmax-family + XLA impls, sampling required
    validate_tier("sampled_spmd", "tied_softmax", sampled=8192, qkv_fused=True)
    validate_tier("sampled_spmd", "softmax", sampled=8192)


@pytest.mark.parametrize(
    "tier,head,kwargs,needle",
    [
        ("spmd", "softmax", {}, "tied head"),
        ("spmd", "binary", {}, "tied head"),
        ("spmd", "tied_softmax", {"sampled": 8192}, "sampled_spmd"),
        ("tp", "tied_softmax", {"qkv_fused": True}, "per-projection"),
        ("tp_spmd", "tied_softmax", {"qkv_fused": True}, "per-projection"),
        ("tp_spmd", "softmax", {}, "tied head"),
        ("tp_spmd", "tied_softmax", {"sampled": 8192}, "sampled_spmd"),
        ("single", "multilabel", {"sampled": 8192}, "softmax-family"),
        ("tp", "tied_softmax", {"sampled": 8192}, "sampled_spmd"),
        ("dp", "tied_softmax", {"sampled": 8192}, "fused-CE sums"),
        ("single", "binary", {"sampled": 8192}, "softmax-family"),
        ("sampled_spmd", "binary", {"sampled": 8192}, "softmax-family"),
        ("sampled_spmd", "multilabel", {"sampled": 8192}, "softmax-family"),
        ("sampled_spmd", "tied_softmax", {}, "num_samples"),
    ],
)
def test_rejected_combinations_raise(tier, head, kwargs, needle):
    with pytest.raises(ValueError, match=needle):
        validate_tier(tier, head, **kwargs)


def test_unknown_tier_and_head():
    with pytest.raises(ValueError, match="unknown tier"):
        validate_tier("pp", "tied_softmax")
    with pytest.raises(ValueError, match="unknown head kind"):
        validate_tier("dp", "regression")


def test_constructors_use_the_matrix():
    """The tier constructors reject through the shared matrix, not local
    ad-hoc checks (tp.py/spmd.py call validate_tier)."""
    import jax
    from bert4clickpath import (
        ClickstreamModel,
        FeatureConfig,
        HeadConfig,
        MeshConfig,
        ModelConfig,
    )
    from bert4clickpath.parallel import spmd
    from bert4clickpath.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(MeshConfig(data=2, model=4))

    cfg_mlp = ModelConfig(
        features={"items": FeatureConfig(128, 16)},
        num_layers=1, num_heads=2, ffn_dim=32, max_len=12,
        head=HeadConfig("softmax", output_size=100),
    )
    with pytest.raises(ValueError, match="tied head"):
        spmd.make_spmd_train_step(cfg_mlp, mesh, None, None, 100)

    import optax

    from bert4clickpath.parallel.tp import make_tp_train_step
    from bert4clickpath.training.schedules import constant

    cfg_tied = ModelConfig(
        features={"items": FeatureConfig(128, 16)},
        num_layers=1, num_heads=4, ffn_dim=32, max_len=12,
        head=HeadConfig("tied_softmax", output_size=100),
    )
    cfg_qkv = ModelConfig(
        features={"items": FeatureConfig(128, 16)},
        num_layers=1, num_heads=4, ffn_dim=32, max_len=12,
        head=HeadConfig("tied_softmax", output_size=100), qkv_fused=True,
    )
    with pytest.raises(ValueError, match="per-projection"):
        make_tp_train_step(
            ClickstreamModel(cfg_qkv), optax.adam(1e-3), constant(1e-3), mesh
        )

    model_xla = ClickstreamModel(cfg_tied)
    with pytest.raises(ValueError, match="num_samples"):
        spmd.make_sampled_spmd_train_step(
            model_xla, mesh, optax.adam(1e-3), constant(1e-3), 100, 0
        )


def test_components_md_table_in_sync():
    """COMPONENTS.md publishes render_matrix() verbatim — regenerating must
    reproduce the committed table, so the doc can't drift from the code."""
    with open(os.path.join(REPO, "COMPONENTS.md")) as f:
        doc = f.read()
    assert render_matrix() in doc, (
        "COMPONENTS.md support table is stale; paste the output of "
        "bert4clickpath.parallel.support.render_matrix()"
    )


def test_driver_validates_before_building():
    """The training driver fails fast with the matrix's reason (not a
    mid-build stack trace) on an unsupported combination."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "examples", "bert4rec", "train.py"),
            "--simulated", "--n_items", "40", "--n_sessions", "200",
            "--model_dir", "/tmp/should_not_exist_support_matrix",
            "--preset", "flagship", "--d_model", "32", "--layers", "1",
            "--heads", "2", "--epochs", "1", "--batch", "32",
            "--max_items", "10", "--sampled_softmax", "64",
            "--parallel", "dp",
        ],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode != 0
    assert "fused-CE sums" in out.stderr


def test_matrix_covers_all_tiers():
    table = render_matrix()
    for t in TIERS:
        assert t in table

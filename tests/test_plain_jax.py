"""The model is plain JAX: no module framework or checkpoint library is
imported, and the parameter trees and init streams keep their established
form (checkpoints, the weight-decay mask, serving and transfer learning
read these paths)."""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath import ClickstreamModel, FeatureConfig, HeadConfig, ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_flax_or_orbax_after_a_train_step_and_checkpoint(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import jax
jax.config.update("jax_platforms", "cpu")
import bench
from bert4clickpath.training import checkpoint
scan_step, state, stacked, rng = bench.build(n_items=200, batch=8, steps=2, max_items=10)
state, losses = scan_step(state, stacked, rng)
checkpoint.save_checkpoint({str(tmp_path)!r}, state, 2)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("flax", "orbax"))
print("BAD", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def _layer_paths(i, qkv_fused=False):
    mha = ["wo", "wqkv"] if qkv_fused else ["wk", "wo", "wq", "wv"]
    paths = [f"encoder/layer_{i}/{m}/{leaf}" for m in ("ffn1", "ffn2") for leaf in ("bias", "kernel")]
    paths += [f"encoder/layer_{i}/{m}/{leaf}" for m in ("ln1", "ln2") for leaf in ("bias", "scale")]
    paths += [f"encoder/layer_{i}/mha/{m}/{leaf}" for m in mha for leaf in ("bias", "kernel")]
    return paths


# path -> shape for 100 simulated items (111 model rows, padded to 1,024
# for the flagship's fused CE); the layer blocks follow _layer_paths
GOLDEN = {
    "flagship": (
        {"embed_items/embedding": (1024, 256), "positions/embedding": (53, 256)},
        4, False,
    ),
    "parity": (
        {
            "embed_items/embedding": (111, 64),
            "head/mlp/dense_0/bias": (1024,), "head/mlp/dense_0/kernel": (64, 1024),
            "head/mlp/dense_1/bias": (512,), "head/mlp/dense_1/kernel": (1024, 512),
            "head/mlp/dense_2/bias": (256,), "head/mlp/dense_2/kernel": (512, 256),
            "head/mlp/dense_3/bias": (128,), "head/mlp/dense_3/kernel": (256, 128),
            "head/out/bias": (100,), "head/out/kernel": (128, 100),
        },
        2, False,
    ),
    "flagship_qkv_pre_bias": (
        {
            "embed_items/embedding": (1024, 64), "positions/embedding": (53, 256),
            "input_proj/bias": (256,), "input_proj/kernel": (64, 256),
            "encoder/ln_final/bias": (256,), "encoder/ln_final/scale": (256,),
            "tied_transform_0/bias": (128,), "tied_transform_0/kernel": (256, 128),
            "tied_transform_ln/bias": (128,), "tied_transform_ln/scale": (128,),
            "tied_proj/bias": (64,), "tied_proj/kernel": (128, 64),
            "tied_out_bias": (100,),
        },
        4, True,
    ),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_param_tree_paths_golden(name):
    sys.path.insert(0, os.path.join(REPO, "examples", "bert4rec"))
    prng_impl = jax.config.jax_default_prng_impl
    try:
        from train import build_model_config  # sets the PRNG impl on import
    finally:
        sys.path.pop(0)
        jax.config.update("jax_default_prng_impl", prng_impl)
    from bert4clickpath.data.generator import ClickStreamGenerator

    vocab = ClickStreamGenerator(n_items=100, session_cohesiveness=200, seed=0).item_vocab()
    args = dict(parity_scale=False, d_model=256, layers=4, heads=4, dropout=0.1,
                max_items=50, head_dims="", dtype="", qkv_fused=False,
                norm_style="post", embed_dim=0, tied_bias=False)
    if name == "flagship_qkv_pre_bias":
        args.update(qkv_fused=True, norm_style="pre", tied_bias=True, head_dims="128",
                    embed_dim=64)
    preset = "parity" if name == "parity" else "flagship"
    cfg = build_model_config(preset, vocab, argparse.Namespace(**args))
    model = ClickstreamModel(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), {"items": jnp.zeros((1, cfg.max_len), jnp.int32)},
        jnp.zeros((1, 10), jnp.int32),
    ))
    assert list(shapes) == ["params"]
    got = {
        "/".join(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"])
    }
    fixed, layers, qkv = GOLDEN[name]
    d, f = cfg.d_model, cfg.ffn_dim
    layer_shapes = {
        "ffn1/bias": (f,), "ffn1/kernel": (d, f), "ffn2/bias": (d,), "ffn2/kernel": (f, d),
        "ln1/bias": (d,), "ln1/scale": (d,), "ln2/bias": (d,), "ln2/scale": (d,),
        "mha/wqkv/bias": (3 * d,), "mha/wqkv/kernel": (d, 3 * d),
        **{f"mha/{m}/bias": (d,) for m in ("wk", "wo", "wq", "wv")},
        **{f"mha/{m}/kernel": (d, d) for m in ("wk", "wo", "wq", "wv")},
    }
    want = dict(fixed)
    for i in range(layers):
        for p in _layer_paths(i, qkv):
            want[p] = layer_shapes[p.split("/", 2)[2]]
    assert got == want


def test_init_stream_is_pinned():
    """A seed initialises the same weights as checkpoints of this tree
    written by the Linen modules it replaced: each parameter's key folds
    the SHA-1 of its module path into the root key."""
    cfg = ModelConfig(features={"items": FeatureConfig(51, 16)}, num_layers=1, num_heads=2,
                      ffn_dim=32, max_len=12, positional="learned",
                      head=HeadConfig("tied_softmax"))
    p = ClickstreamModel(cfg).init(
        jax.random.key(0, impl="threefry2x32"), {"items": jnp.zeros((1, 12), jnp.int32)},
        jnp.zeros((1, 4), jnp.int32),
    )["params"]
    pinned = {
        ("embed_items", "embedding", 11): [0.5212435722351074, 0.0501236654818058, 0.30429598689079285],
        ("encoder", "layer_0", "mha", "wq", "kernel", 0): [-0.07228714972734451, -0.3418067693710327, 0.09920776635408401],
        ("encoder", "layer_0", "ffn2", "kernel", 0): [-0.25101223587989807, -0.33368438482284546, -0.06705953925848007],
        ("positions", "embedding", 0): [0.02708803303539753, 0.002065749606117606, -0.007598496042191982],
    }
    for path, want in pinned.items():
        leaf = p
        for k in path[:-1]:
            leaf = leaf[k]
        np.testing.assert_array_equal(np.asarray(leaf[path[-1], :3]), np.float32(want))
    for kind in ("bias", "scale"):
        want = 0.0 if kind == "bias" else 1.0
        np.testing.assert_array_equal(np.asarray(p["encoder"]["layer_0"]["ln1"][kind]), want)


def test_deprecated_package_name_aliases():
    """The package's former name (the alias package beside it) still
    imports, warns, and yields the very same modules and classes."""
    old = next(
        n for n in sorted(os.listdir(REPO))
        if n.startswith("bert4clickpath_") and os.path.isfile(os.path.join(REPO, n, "__init__.py"))
    )
    code = f"""
import sys, warnings
sys.path.insert(0, {REPO!r})
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    import {old} as alias
    from {old}.models.model import ClickstreamModel
import bert4clickpath
from bert4clickpath.models import model
import {old}.ops.fused_ce as ce
print(alias is bert4clickpath, ClickstreamModel is model.ClickstreamModel,
      ce is sys.modules["bert4clickpath.ops.fused_ce"],
      [str(x.category.__name__) for x in w])
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True True True ['DeprecationWarning']", out.stdout

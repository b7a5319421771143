"""Attention implementations of the encoder and the choice between them.

``attention_cudnn`` (cuDNN's fused flash attention on the GPU) is checked
here through ``jax.nn.dot_product_attention(implementation="xla")``: the
same head layout, bias and odd-length padding, run by XLA on the CPU. The
cuDNN call itself is compared with the per-head path on the card by
chip_smoke.py's attention phase."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.constants import PAD_ID
from bert4clickpath.models import encoder as E
from bert4clickpath.ops.masking import NEG_INF, padding_bias

xla_flash = functools.partial(E.attention_cudnn, implementation="xla")


def _reference(q, k, v, bias, h):
    """Plain 4-D masked softmax attention in f32."""
    b, l, d = q.shape
    split = lambda t: jnp.transpose(t.reshape(b, l, h, d // h), (0, 2, 1, 3))  # noqa: E731
    s = jnp.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / np.sqrt(d // h)
    if bias is not None:
        s = s + bias
    out = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), split(v))
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(b, l, d)


def _inputs(b=3, l=12, h=2, dh=8, seed=5, pad_frac=0.25):
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.normal(size=(b, l, h * dh)), jnp.float32) for _ in range(3))
    bias = np.where(rng.random((b, 1, 1, l)) < pad_frac, NEG_INF, 0.0).astype(np.float32)
    return q, k, v, jnp.asarray(bias)


@pytest.mark.parametrize("l,h", [(16, 2), (17, 2), (53, 4), (8, 1)])
def test_flash_layout_matches_reference(l, h):
    """Even and odd lengths (odd ones take the padded key/query path)."""
    q, k, v, bias = _inputs(l=l, h=h)
    np.testing.assert_allclose(
        np.asarray(xla_flash(q, k, v, bias, h)), np.asarray(_reference(q, k, v, bias, h)),
        atol=1e-5,
    )


@pytest.mark.parametrize("l", [16, 17])
def test_per_head_matches_reference(l):
    q, k, v, bias = _inputs(l=l, h=4, dh=4)
    np.testing.assert_allclose(
        np.asarray(E.attention_per_head(q, k, v, bias, 4)),
        np.asarray(_reference(q, k, v, bias, 4)), atol=1e-5,
    )


def test_flash_grads_match_per_head():
    q, k, v, bias = _inputs(l=13)

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, bias, 2) ** 2)

    got = jax.grad(functools.partial(loss, xla_flash), argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(functools.partial(loss, E.attention_per_head), argnums=(0, 1, 2))(q, k, v)
    for a, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_fully_padded_rows_stay_finite():
    """A session that is all padding gets a zero bias from padding_bias, so
    both paths attend over its scores alike: finite, equal outputs and
    gradients, odd length included."""
    q, k, v, _ = _inputs(l=11, pad_frac=0.0)
    tokens = np.full((3, 11), PAD_ID + 5, np.int32)
    tokens[0] = PAD_ID
    tokens[1, 6:] = PAD_ID
    bias = padding_bias(jnp.asarray(tokens))

    def loss(fn, q, k, v):
        return jnp.sum(jnp.sin(fn(q, k, v, bias, 2)))

    got = xla_flash(q, k, v, bias, 2)
    assert bool(jnp.all(jnp.isfinite(got)))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(E.attention_per_head(q, k, v, bias, 2)), atol=1e-5
    )
    g_got = jax.grad(functools.partial(loss, xla_flash), argnums=(0, 1, 2))(q, k, v)
    g_want = jax.grad(functools.partial(loss, E.attention_per_head), argnums=(0, 1, 2))(q, k, v)
    for a, w in zip(g_got, g_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_no_bias_and_bf16():
    q, k, v, _ = _inputs(l=10)
    np.testing.assert_allclose(
        np.asarray(xla_flash(q, k, v, None, 2)), np.asarray(_reference(q, k, v, None, 2)),
        atol=1e-5,
    )
    qb, kb, vb = (t.astype(jnp.bfloat16) for t in (q, k, v))
    out = xla_flash(qb, kb, vb, None, 2)
    assert out.dtype == jnp.bfloat16 and out.shape == q.shape
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(_reference(q, k, v, None, 2)), atol=5e-2
    )


def test_model_with_cudnn_attention():
    """The model traced with the cuDNN wrapper (its call run by XLA here)
    equals the per-head path, end to end."""
    from bert4clickpath import ClickstreamModel, FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath.constants import CLS_ID, SEP_ID

    cfg = ModelConfig(
        features={"items": FeatureConfig(51, 16)}, num_layers=1, num_heads=2,
        ffn_dim=32, max_len=15, head=HeadConfig("tied_softmax"), max_masked=4,
    )
    rng = np.random.default_rng(0)
    tokens = rng.integers(10, 50, size=(2, 15)).astype(np.int32)
    tokens[:, 0], tokens[:, 1], tokens[:, -1] = CLS_ID, SEP_ID, SEP_ID
    tokens[1, 9:14] = PAD_ID
    feats = {"items": jnp.asarray(tokens)}
    pos = jnp.asarray(np.tile(np.array([2, 3, 4, 5], np.int32), (2, 1)))
    model = ClickstreamModel(cfg)
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    with E.forced_attention(xla_flash):
        got = model.apply(params, feats, pos)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(model.apply(params, feats, pos)), rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("backend,dtype,head_dim,want", [
    ("gpu", jnp.bfloat16, 64, "cudnn"),
    ("gpu", jnp.float16, 128, "cudnn"),
    ("gpu", jnp.float32, 64, "per_head"),  # cuDNN's flash kernels take 16-bit operands
    ("gpu", jnp.bfloat16, 12, "per_head"),  # head width not a multiple of 8
    ("gpu", jnp.bfloat16, 256, "per_head"),
    ("cpu", jnp.bfloat16, 64, "per_head"),
])
def test_pick_attention(monkeypatch, backend, dtype, head_dim, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    fn = E.pick_attention(dtype, head_dim)
    assert fn is {"cudnn": E.attention_cudnn, "per_head": E.attention_per_head}[want]


def test_forced_attention_overrides_and_restores():
    with E.forced_attention(xla_flash):
        assert E.pick_attention(jnp.float32, 4) is xla_flash
        with E.forced_attention(E.attention_per_head):
            assert E.pick_attention(jnp.bfloat16, 64) is E.attention_per_head
        assert E.pick_attention(jnp.float32, 4) is xla_flash
    assert E.pick_attention(jnp.float32, 4) is E.attention_per_head


def test_padding_bias_blinds_pads_of_live_sessions_only():
    tokens = np.full((3, 6), PAD_ID + 9, np.int32)
    tokens[0] = PAD_ID
    tokens[1, 4:] = PAD_ID
    bias = np.asarray(padding_bias(jnp.asarray(tokens)))
    assert bias.shape == (3, 1, 1, 6) and bias.dtype == np.float32
    np.testing.assert_array_equal(bias[0], 0.0)
    np.testing.assert_array_equal(bias[1, 0, 0], [0, 0, 0, 0, NEG_INF, NEG_INF])
    np.testing.assert_array_equal(bias[2], 0.0)

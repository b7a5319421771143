"""Bidirectional (encoder-only) Transformer stack, in plain JAX.

Same semantics as the reference encoder (transformer.py:100-268): post-LN
residual blocks, ReLU feed-forward, padding-masked bidirectional attention,
LayerNorm eps 1e-6, dropout on attention output / ffn output / encoder input.

* Attention (:func:`pick_attention`): on the GPU, for 16-bit operands,
  cuDNN's fused flash attention (:func:`attention_cudnn`), which keeps the
  (L, L) scores on chip; otherwise the per-head XLA path
  (:func:`attention_per_head`): matmuls over slices of the flat (B, L, D)
  projections with an f32 softmax, and no (B, L, H, Dh) tensor for XLA to
  transpose.
* ``remat`` wraps each layer in ``jax.checkpoint`` to trade FLOPs for
  device memory on deep configs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from bert4clickpath.models import layers
from bert4clickpath.ops.masking import NEG_INF

# Dropout salts (layers.dropout): the encoder input and, per layer i, the
# attention output (2i) and the ffn output (2i + 1). The tensor-parallel
# encoder (parallel/tp_spmd.py) draws from the same salts.
INPUT_DROPOUT_SALT = 10_000


def attention_per_head(
    qf: jnp.ndarray,
    kf: jnp.ndarray,
    vf: jnp.ndarray,
    bias: Optional[jnp.ndarray],
    num_heads: int,
) -> jnp.ndarray:
    """Masked MHA over the flat (B, L, D) projections, one head at a time.

    Heads are sub-ranges of D; each head's attention is a pair of 3-D
    einsums over contiguous slices, so no (B, L, H, Dh) tensor ever exists
    and XLA's layout assignment has nothing to transpose. Softmax
    accumulates in f32 regardless of compute dtype (the reference,
    transformer.py:64-97, was pure f32).
    """
    d = qf.shape[-1]
    dh = d // num_heads
    b2 = None if bias is None else bias[:, 0, 0][:, None, :].astype(jnp.float32)
    outs = []
    for h in range(num_heads):
        sl = slice(h * dh, (h + 1) * dh)
        s = jnp.einsum(
            "bqd,bkd->bqk", qf[..., sl], kf[..., sl],
            preferred_element_type=jnp.float32,
        ) / jnp.sqrt(jnp.float32(dh))
        if b2 is not None:
            s = s + b2
        p = jax.nn.softmax(s, axis=-1).astype(qf.dtype)
        outs.append(jnp.einsum("bqk,bkd->bqd", p, vf[..., sl]))
    return jnp.concatenate(outs, axis=-1)


def attention_cudnn(
    qf: jnp.ndarray,
    kf: jnp.ndarray,
    vf: jnp.ndarray,
    bias: Optional[jnp.ndarray],
    num_heads: int,
    implementation: str = "cudnn",
) -> jnp.ndarray:
    """Masked MHA over the flat (B, L, D) projections through
    ``jax.nn.dot_product_attention`` — cuDNN's fused flash attention.

    cuDNN takes the padding bias only as a full (B, 1, L, L) tensor, and
    its training kernels take a bias only at an even L: an odd L gets one
    more key, blinded by the bias, and one more query row, dropped from the
    output. Outputs and gradients equal :func:`attention_per_head`'s up to
    rounding, sessions that are all padding included (``padding_bias``
    gives those a finite bias). ``implementation="xla"`` runs the same
    layout and padding through XLA (for checking them off the GPU).
    """
    b, l, d = qf.shape
    lp = l + l % 2
    if lp != l:
        qf, kf, vf = (jnp.pad(t, ((0, 0), (0, lp - l), (0, 0))) for t in (qf, kf, vf))
    key_bias = jnp.zeros((b, l), jnp.float32) if bias is None else bias[:, 0, 0, :]
    key_bias = jnp.pad(key_bias, ((0, 0), (0, lp - l)), constant_values=NEG_INF)
    full = jnp.broadcast_to(key_bias[:, None, None, :], (b, 1, lp, lp)).astype(qf.dtype)
    heads = lambda t: t.reshape(b, lp, num_heads, d // num_heads)  # noqa: E731
    out = jax.nn.dot_product_attention(
        heads(qf), heads(kf), heads(vf), bias=full, implementation=implementation
    )
    return out.reshape(b, lp, d)[:, :l]


Attention = Callable[..., jnp.ndarray]
_forced: Optional[Attention] = None


@contextlib.contextmanager
def forced_attention(fn: Attention):
    """Trace the encoder with ``fn`` (``attention_per_head`` or
    ``attention_cudnn``) whatever :func:`pick_attention` would choose, for
    benchmarks that race the two. The choice is made when a step is
    traced, so build the step and make its first call inside the block."""
    global _forced
    prev, _forced = _forced, fn
    try:
        yield
    finally:
        _forced = prev


def pick_attention(dtype, head_dim: int) -> Attention:
    """cuDNN's flash attention on the GPU when its kernels take the
    operands (bf16/f16, a head width that is a multiple of 8 up to 128);
    the per-head path otherwise. On the H100 cuDNN is the faster of the two
    in the flagship train step at L=53 and at L=512."""
    if _forced is not None:
        return _forced
    if (
        jax.default_backend() == "gpu"
        and jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
        and head_dim % 8 == 0
        and head_dim <= 128
    ):
        return attention_cudnn
    return attention_per_head


class Encoder:
    """The encoder stack. ``init_params(key)`` builds its parameter tree
    (``layer_<i>``: ``mha``/``ln1``/``ln2``/``ffn1``/``ffn2``, plus
    ``ln_final`` for pre-LN); ``apply({'params': p}, x, bias, deterministic,
    rngs={'dropout': key})`` runs it."""

    def __init__(
        self,
        num_layers: int,
        d_model: int,
        num_heads: int,
        ffn_dim: int,
        dropout_rate: float,
        dtype=jnp.float32,
        remat: bool = False,
        qkv_fused: bool = False,
        # "post" = reference residual order (transformer.py:202-213). "pre"
        # normalizes the sublayer INPUT and keeps the residual stream
        # un-normed (GPT-2/T5 style) — the standard fix for post-LN's depth
        # instability: BASELINE.md measured 6L post-LN collapsing (~-45%
        # NDCG) under every LR tried. Param tree is identical (ln1/ln2
        # reused) except the stack's ln_final.
        norm_style: str = "post",
    ):
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.ffn_dim = ffn_dim
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.remat = remat
        # single (D, 3D) projection instead of three (D, D) ones; param tree
        # changes (wqkv), see ModelConfig
        self.qkv_fused = qkv_fused
        self.norm_style = norm_style

    def init_params(self, key: jax.Array) -> dict:
        d, k = self.d_model, layers.child_key
        out = {}
        for i in range(self.num_layers):
            lk = k(key, f"layer_{i}")
            mk = k(lk, "mha")
            if self.qkv_fused:
                mha = {"wqkv": layers.dense_params(k(mk, "wqkv"), d, 3 * d)}
            else:
                mha = {n: layers.dense_params(k(mk, n), d, d) for n in ("wq", "wk", "wv")}
            mha["wo"] = layers.dense_params(k(mk, "wo"), d, d)
            out[f"layer_{i}"] = {
                "mha": mha,
                "ln1": layers.layer_norm_params(d),
                "ln2": layers.layer_norm_params(d),
                "ffn1": layers.dense_params(k(lk, "ffn1"), d, self.ffn_dim),
                "ffn2": layers.dense_params(k(lk, "ffn2"), self.ffn_dim, d),
            }
        if self.norm_style == "pre":
            out["ln_final"] = layers.layer_norm_params(d)
        return out

    def _mha(self, p: dict, x: jnp.ndarray, bias) -> jnp.ndarray:
        dt, d = self.dtype, self.d_model
        if self.qkv_fused:
            qkv = layers.dense(p["wqkv"], x, dt)
            qf, kf, vf = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        else:
            qf, kf, vf = (layers.dense(p[n], x, dt) for n in ("wq", "wk", "wv"))
        attend = pick_attention(dt, d // self.num_heads)
        return layers.dense(p["wo"], attend(qf, kf, vf, bias, self.num_heads), dt)

    def _layer(self, p: dict, x: jnp.ndarray, bias, rng, i: int) -> jnp.ndarray:
        dt, rate = self.dtype, self.dropout_rate

        def ffn(h):
            return layers.dense(p["ffn2"], jax.nn.relu(layers.dense(p["ffn1"], h, dt)), dt)

        def drop(t, salt):
            return layers.dropout(t, rate, rng, salt)

        if self.norm_style == "pre":
            x = x + drop(self._mha(p["mha"], layers.layer_norm(p["ln1"], x, dt), bias), 2 * i)
            return x + drop(ffn(layers.layer_norm(p["ln2"], x, dt)), 2 * i + 1)
        # Post-LN residual, eps 1e-6 (reference transformer.py:183-184,202-213)
        x = layers.layer_norm(p["ln1"], x + drop(self._mha(p["mha"], x, bias), 2 * i), dt)
        return layers.layer_norm(p["ln2"], x + drop(ffn(x), 2 * i + 1), dt)

    def apply(self, variables: dict, x: jnp.ndarray, bias, deterministic: bool, rngs=None):
        params = variables["params"]
        rng = None if deterministic else _dropout_rng(rngs, self.dropout_rate)
        x = layers.dropout(x, self.dropout_rate, rng, INPUT_DROPOUT_SALT)
        for i in range(self.num_layers):
            layer = lambda p, x, bias, rng, i=i: self._layer(p, x, bias, rng, i)  # noqa: E731
            if self.remat:
                layer = jax.checkpoint(layer)
            x = layer(params[f"layer_{i}"], x, bias, rng)
        if self.norm_style == "pre":
            # pre-LN leaves the residual stream un-normalized; one final LN
            # feeds the head the same normalized scale post-LN produced
            x = layers.layer_norm(params["ln_final"], x, self.dtype)
        return x


def _dropout_rng(rngs, rate: float):
    rng = None if rngs is None else rngs.get("dropout")
    if rng is None and rate > 0.0:
        raise ValueError("non-deterministic apply needs rngs={'dropout': key}")
    return rng

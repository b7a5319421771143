"""Plain-JAX layers: parameter builders and the functions that apply them.

Each layer is a pair: a ``*_params(key, ...)`` function that builds its
parameter dict, and a pure function of ``(params, inputs)``. Parameter names
(``kernel``/``bias``, ``scale``/``bias``, ``embedding``), initialisers and
dtype handling are those of the standard Dense / LayerNorm / Embed /
Dropout layers, so parameter trees, checkpoints and numerics keep their
established form:

* dense: LeCun-normal kernel, zero bias; inputs, kernel and bias are cast to
  the compute dtype before the matmul;
* layer norm: statistics in at least float32, ``E[x^2] - E[x]^2`` variance
  clipped at 0, result cast to the compute dtype;
* embedding: N(0, 1/width) rows;
* dropout: Bernoulli keep mask, survivors scaled by ``1 / keep_prob``.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

kernel_init = jax.nn.initializers.lecun_normal()
embed_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0
)


class InitKey(NamedTuple):
    """A root PRNG key and the module path of the parameters it seeds."""

    root: jax.Array
    path: tuple = ()


def child_key(key, name: str) -> InitKey:
    """The init key of submodule ``name`` under ``key`` (a PRNG key or an
    :class:`InitKey`)."""
    if not isinstance(key, InitKey):
        key = InitKey(key)
    return InitKey(key.root, key.path + (name,))


def param_key(key: InitKey, index: int = 1) -> jax.Array:
    """The PRNG key of the ``index``-th (1-based, in creation order)
    parameter of the module at ``key.path``: the root key folded with the
    first 4 bytes of the SHA-1 of the path's names and the index. A
    parameter's stream depends on its path alone, and matches the standard
    Linen derivation, so a given seed initialises the same weights as
    checkpoints written by Linen modules of the same tree."""
    m = hashlib.sha1()
    for x in (*key.path, index):
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key.root, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def dense_params(key: InitKey, d_in: int, d_out: int) -> dict:
    return {
        "kernel": kernel_init(param_key(key), (d_in, d_out), jnp.float32),
        "bias": jnp.zeros((d_out,), jnp.float32),
    }


def dense(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    x = x.astype(dtype)
    y = lax.dot_general(
        x, p["kernel"].astype(dtype), (((x.ndim - 1,), (0,)), ((), ()))
    )
    return y + p["bias"].astype(dtype)


def layer_norm_params(d: int) -> dict:
    return {"scale": jnp.ones((d,), jnp.float32), "bias": jnp.zeros((d,), jnp.float32)}


def layer_norm(p: dict, x: jnp.ndarray, dtype, eps: float = 1e-6) -> jnp.ndarray:
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(0.0, jnp.mean(lax.square(xf), axis=-1, keepdims=True) - lax.square(mean))
    y = (x - mean) * (lax.rsqrt(var + eps) * p["scale"]) + p["bias"]
    return y.astype(dtype)


def embed_params(key: InitKey, rows: int, width: int) -> dict:
    return {"embedding": embed_init(param_key(key), (rows, width), jnp.float32)}


def dropout(x: jnp.ndarray, rate: float, rng, salt: int) -> jnp.ndarray:
    """Inverted dropout with the key ``fold_in(rng, salt)``; identity when
    ``rng`` is None (deterministic) or the rate is 0. Every dropout site of
    a model passes its own salt, so sites draw independent masks."""
    if rng is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = jax.random.bernoulli(jax.random.fold_in(rng, salt), keep_prob, x.shape)
    return lax.select(keep, x / keep_prob, jnp.zeros_like(x))

"""Collectives with hand-written VJPs for use inside ``jax.shard_map``.

This package's shard_map tiers run with replication checking off
(``check_vma=False``), where autodiff mis-transposes raw collectives — so
every collective that autodiff can see gets an explicit VJP (the same
discipline as :mod:`bert4clickpath.parallel.embedding`). The two
primitives here are the Megatron f/g conjugate pair (Shoeybi et al. 2019)
that tensor-parallel layers are built from:

* :func:`psum_fwd` ("g") — all-reduce forward, identity backward. Placed
  where row-parallel partial sums are assembled; the cotangent of the
  (replicated) output is already the full gradient for each shard's
  partial.
* :func:`psum_bwd` ("f") — identity forward, all-reduce backward. Placed
  where a replicated activation fans out into column-parallel compute; each
  shard's input-cotangent contribution is partial over the model axis and
  must be summed to preserve the replicated-activation / replicated-
  cotangent invariant.

No reference equivalent (the reference's only collective was the NCCL
all-reduce hidden inside MirroredStrategy, source/main.py:52).
"""

from __future__ import annotations

import functools

import jax


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def psum_fwd(x, axis_name: str):
    """All-reduce forward / identity backward (Megatron "g")."""
    return jax.lax.psum(x, axis_name)


def _g_fwd(x, axis_name):
    return jax.lax.psum(x, axis_name), None


def _g_bwd(axis_name, _, ct):
    # out is replicated, so its cotangent is replicated: each shard's partial
    # input receives exactly d out — no collective in the backward.
    return (ct,)


psum_fwd.defvjp(_g_fwd, _g_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def psum_bwd(x, axis_name: str):
    """Identity forward / all-reduce backward (Megatron "f")."""
    return x


def _f_fwd(x, axis_name):
    return x, None


def _f_bwd(axis_name, _, ct):
    # each model shard contributed only its slice of the downstream compute,
    # so its input cotangent is partial — sum to get the full gradient on
    # every shard (keeping the replicated invariant for everything upstream)
    return (jax.lax.psum(ct, axis_name),)


psum_bwd.defvjp(_f_fwd, _f_bwd)

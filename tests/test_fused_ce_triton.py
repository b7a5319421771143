"""The fused CE's GPU kernels (ops/fused_ce_triton.py) in Pallas interpret
mode on the CPU, against a dense reference and the plain scan; and the
choice of implementation by backend. The compiled kernels are checked on
the card by chip_smoke.py's ce phase."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS as OFF
from bert4clickpath.ops import fused_ce as F
from bert4clickpath.ops import fused_ce_triton as T

# (rows, width, table rows, valid rows, with bias): one tile, a ragged
# row count, a valid window crossing vocab tiles, several row tiles
CASES = [
    (16, 8, 64, 40, False),
    (24, 8, 64, 40, True),
    (300, 48, 704, 600, True),
    (130, 64, 1024, 1000, False),
]

_INTERPRET = types.SimpleNamespace(
    fwd_stats=functools.partial(T.fwd_stats, interpret=True),
    bwd=functools.partial(T.bwd, interpret=True),
)


def _case(n, d, v, nv, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(v, d)) / np.sqrt(d), jnp.float32)
    b = jnp.asarray(rng.normal(size=(v,)), jnp.float32) if bias else None
    labels = rng.integers(0, nv, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    return x, table, b, jnp.asarray(labels)


def _dense_logits(x, table, b, nv):
    logits = x @ table.T + (0.0 if b is None else b)
    rows = jnp.arange(table.shape[0])
    return jnp.where((rows >= OFF) & (rows < OFF + nv), logits, F.NEG_BIG)


@pytest.mark.parametrize("n,d,v,nv,bias", CASES)
def test_fwd_stats_match_dense(n, d, v, nv, bias):
    x, table, b, _ = _case(n, d, v, nv, bias)
    m, l = T.fwd_stats(x, table, jnp.int32(OFF), jnp.int32(OFF + nv), b, interpret=True)
    want = jax.nn.logsumexp(_dense_logits(x, table, b, nv), axis=1)
    np.testing.assert_allclose(np.asarray(m + jnp.log(l)), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,v,nv,bias", CASES)
def test_bwd_matches_scan(n, d, v, nv, bias):
    """dx, dW (and db) of the kernels equal the plain scan's, pad rows
    (dnll 0, label -1) included."""
    x, table, b, labels = _case(n, d, v, nv, bias, seed=1)
    lab = F._labels_model(labels, OFF)
    logz = jax.nn.logsumexp(_dense_logits(x, table, b, nv), axis=1)
    dnll = (labels != LABEL_PAD).astype(jnp.float32) / n
    lo, hi = jnp.int32(OFF), jnp.int32(OFF + nv)
    want = F._xla_bwd(x, table, lab, logz, dnll, lo, hi, b)
    got = T.bwd(x, table, lab, logz, dnll, lo, hi, b, interpret=True)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_custom_vjp_through_kernels_matches_dense(monkeypatch, bias):
    """The public op with the kernels behind it: loss and gradients equal
    the dense reference, blinded rows get no table gradient, and an
    out-of-catalog label blinds to a huge nll."""
    monkeypatch.setattr(F, "_impl", lambda: _INTERPRET)
    nv = 100
    x, table, b, labels = _case(40, 16, 128, nv, True, seed=2)
    labels = labels.at[7].set(nv + 3)  # a real table row beyond the catalog
    keep = jnp.ones_like(labels, dtype=jnp.float32).at[7].set(0.0)

    def fused(x, t, b):
        if bias:
            nll = F.fused_softmax_ce_bias(x, t, b, labels, OFF, nv)
        else:
            nll = F.fused_softmax_ce(x, t, labels, OFF, nv)
        return jnp.sum(nll * keep), nll

    def dense(x, t, b):
        logits = _dense_logits(x, t, b if bias else None, nv)
        lab = jnp.where(labels == LABEL_PAD, 0, labels + OFF)
        pick = jnp.take_along_axis(logits, lab[:, None], axis=1)[:, 0]
        nll = (jax.nn.logsumexp(logits, axis=1) - pick) * (labels != LABEL_PAD)
        return jnp.sum(nll * keep), nll

    (lf, nll), gf = jax.value_and_grad(fused, argnums=(0, 1, 2), has_aux=True)(x, table, b)
    (ld, _), gd = jax.value_and_grad(dense, argnums=(0, 1, 2), has_aux=True)(x, table, b)
    assert float(nll[7]) > 1e20
    np.testing.assert_allclose(float(lf), float(ld), rtol=1e-5)
    for a, w in zip(gf[: 3 if bias else 2], gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=1e-4, atol=1e-6)
    blinded = np.ones(table.shape[0], bool)
    blinded[OFF : OFF + nv] = False
    np.testing.assert_array_equal(np.asarray(gf[1])[blinded], 0.0)


def test_sharded_through_kernels_matches_dense(monkeypatch):
    """sharded_fused_softmax_ce_bias inside shard_map on a (data=2,
    model=4) CPU mesh, each shard running the kernels: equals the dense
    loss and gradients."""
    from jax.sharding import PartitionSpec as P

    from bert4clickpath.config import MeshConfig
    from bert4clickpath.ops.losses import masked_softmax_cross_entropy
    from bert4clickpath.parallel.mesh import make_mesh

    monkeypatch.setattr(F, "_impl", lambda: _INTERPRET)
    mesh = make_mesh(MeshConfig(data=2, model=4))
    rng = np.random.default_rng(5)
    v, d, nv = 512, 16, 400  # 128 rows per shard
    x = jnp.asarray(rng.normal(size=(4, 8, d)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(v, d)) / 4, jnp.float32)
    bias = jnp.asarray(rng.normal(size=(v,)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, nv, size=(4, 8)), jnp.int32).at[0, 3].set(LABEL_PAD)

    def mapped(x, t, b, lbl):
        f = lambda x, t, b: F.sharded_fused_softmax_ce_bias(  # noqa: E731
            x, t, b, lbl, OFF, nv, "model", "data"
        )
        loss, (gx, gt, gb) = jax.value_and_grad(f, argnums=(0, 1, 2))(x, t, b)
        return loss, (gx, jax.lax.psum(gt, "data"), jax.lax.psum(gb, "data"))

    loss, (gx, gt, gb) = jax.jit(jax.shard_map(
        mapped, mesh=mesh,
        in_specs=(P("data", None, None), P("model", None), P(), P("data", None)),
        out_specs=(P(), (P("data", None, None), P("model", None), P())),
        check_vma=False,
    ))(x, table, bias, labels)

    def dense(x, t, b):
        logits = jnp.einsum("bpd,vd->bpv", x, t[OFF : OFF + nv]) + b[OFF : OFF + nv]
        return masked_softmax_cross_entropy(logits, labels)

    want, (wgx, wgt, wgb) = jax.value_and_grad(dense, argnums=(0, 1, 2))(x, table, bias)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for a, w in ((gx, wgx), (gt, wgt), (gb, wgb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_bf16_operands_accumulate_in_f32():
    """bf16 operands: the kernels' stats equal a float32 reference over the
    same bf16-rounded operands to f32-accumulation accuracy."""
    x, table, _, _ = _case(130, 64, 1024, 1000, False, seed=4)
    xb, tb = x.astype(jnp.bfloat16), table.astype(jnp.bfloat16)
    m, l = T.fwd_stats(xb, tb, jnp.int32(OFF), jnp.int32(OFF + 1000), interpret=True)
    want = jax.nn.logsumexp(
        _dense_logits(xb.astype(jnp.float32), tb.astype(jnp.float32), None, 1000), axis=1
    )
    np.testing.assert_allclose(np.asarray(m + jnp.log(l)), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "row_tiles,vocab_tiles,want",
    [
        (20, 864, 12),  # flagship: N=2,560 in 128-row tiles, 55,296 rows
        (1, 1, 1),
        (3, 11, 11),  # prime tile count: one tile per split
        (300, 864, 1),  # rows alone fill the card
    ],
)
def test_splits_fill_the_card(row_tiles, vocab_tiles, want):
    s = T._splits(row_tiles, vocab_tiles)
    assert s == want and vocab_tiles % s == 0


@pytest.mark.parametrize(
    "fixed,streamed,stages,d,itemsize,want",
    [
        (128, 64, 4, 256, 2, (128, 64, 4)),  # flagship forward, bf16: as tuned
        (64, 128, 2, 256, 2, (64, 128, 2)),  # flagship dW, bf16: as tuned
        (128, 64, 4, 256, 4, (128, 32, 2)),  # float32 forward
        (64, 128, 2, 256, 4, (64, 64, 2)),  # float32 dW
        (128, 64, 4, 1024, 2, (64, 16, 2)),  # a wide model, bf16
    ],
)
def test_tiles_fit_shared_memory(fixed, streamed, stages, d, itemsize, want):
    got = T._fit(fixed, streamed, stages, T._width(d), itemsize)
    assert got == want
    f, s, st = got
    assert (f + st * s) * T._width(d) * itemsize <= T.SMEM_BYTES


@pytest.mark.parametrize(
    "backend,want", [("gpu", "triton"), ("cpu", "xla"), ("rocm", None), ("neuron", None)]
)
def test_impl_by_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(NotImplementedError):
            F._impl()
    else:
        assert F._impl() is (T if want == "triton" else F._XLA)


@pytest.mark.parametrize("name,want", [("triton", "triton"), ("xla", "xla")])
def test_forced_impl_overrides_backend(name, want):
    """forced_impl picks an implementation whatever the backend, and
    restores the backend's choice after the block."""
    with F.forced_impl(name):
        assert F._impl() is (T if want == "triton" else F._XLA)
    assert F._impl() is F._XLA  # the CPU's choice


def test_forced_impl_rejects_unknown():
    with pytest.raises(ValueError, match="not in"):
        with F.forced_impl("pallas"):
            pass


@pytest.mark.parametrize("setting,want", [(None, None), ("highest", "HIGHEST"), ("float32", "HIGHEST")])
def test_kernel_dots_follow_matmul_precision(setting, want):
    """The kernels' dots take their precision from
    ``jax.default_matmul_precision`` when traced: full float32 products
    under "highest"/"float32" (TF32 on the GPU otherwise), as XLA's dots."""
    import contextlib
    import re

    x, table, _, _ = _case(16, 8, 64, 40, False)
    ctx = jax.default_matmul_precision(setting) if setting else contextlib.nullcontext()
    with ctx:
        jaxpr = str(jax.make_jaxpr(
            lambda x, t: T.fwd_stats(x, t, jnp.int32(OFF), jnp.int32(OFF + 40), interpret=True)
        )(x, table))
    n_dots = jaxpr.count("dot_general[")
    precisions = re.findall(r"precision=(\([^)]*\))", jaxpr)  # a default one is not printed
    assert n_dots > 0
    if want is None:
        assert precisions == []
    else:
        assert precisions == [f"(Precision.{want}, Precision.{want})"] * n_dots


def test_sharded_dx_rounds_once():
    """bf16 activations: the vocab-sharded CE sums the shards' dx parts in
    f32 and rounds once, so its dx matches the single-device op's to one
    bf16 rounding, even where the parts cancel (the label's shard pulls the
    other way from the rest)."""
    from jax.sharding import PartitionSpec as P

    from bert4clickpath.config import MeshConfig
    from bert4clickpath.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=1, model=4), jax.devices()[:4])
    rng = np.random.default_rng(7)
    v, d, nv = 512, 32, 480
    x = jnp.asarray(rng.normal(size=(4, 16, d)), jnp.bfloat16)
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, nv, size=(4, 16)), jnp.int32)

    def sharded(x, t):
        return jax.grad(lambda x: F.sharded_fused_softmax_ce(x, t, labels, OFF, nv, "model"))(x)

    got = jax.jit(jax.shard_map(
        sharded, mesh=mesh, in_specs=(P(), P("model", None)), out_specs=P(), check_vma=False,
    ))(x, table)
    want = jax.grad(lambda x: F.fused_masked_softmax_cross_entropy(x, table, labels, OFF, nv))(x)
    assert got.dtype == want.dtype == jnp.bfloat16
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_less(np.abs(got - want), 2.0 ** -8 * np.abs(want) + 1e-12)

"""Fused CE vs the dense oracle: the public ops on the CPU run the chunked
scan; the GPU kernels are checked in interpret mode (test_fused_ce_triton.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath.ops.losses import masked_softmax_cross_entropy
from bert4clickpath.ops.fused_ce import (
    fused_masked_softmax_cross_entropy,
    fused_softmax_ce,
)


def _case(n=16, d=8, v=64, num_valid=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, num_valid, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    return jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels)


def _dense_nll(x, table, labels, num_valid):
    logits = x @ table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + num_valid].T
    logz = jax.nn.logsumexp(logits, axis=-1)
    safe = jnp.where(labels == LABEL_PAD, 0, labels)
    picked = jnp.take_along_axis(logits, safe[:, None], axis=1)[:, 0]
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    return (logz - picked) * mask


def test_forward_matches_dense():
    x, table, labels = _case()
    nll = fused_softmax_ce(x, table, labels, NUM_RESERVED_TOKENS, 40)
    want = _dense_nll(x, table, labels, 40)
    np.testing.assert_allclose(np.asarray(nll), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_forward_all_pad_rows_zero():
    x, table, labels = _case()
    labels = jnp.full_like(labels, LABEL_PAD)
    nll = fused_softmax_ce(x, table, labels, NUM_RESERVED_TOKENS, 40)
    np.testing.assert_array_equal(np.asarray(nll), 0.0)


def test_gradients_match_dense():
    x, table, labels = _case()

    def fused_loss(x, t):
        nll = fused_softmax_ce(x, t, labels, NUM_RESERVED_TOKENS, 40)
        return jnp.sum(nll) / jnp.maximum(
            jnp.sum((labels != LABEL_PAD).astype(jnp.float32)), 1.0
        )

    def dense_loss(x, t):
        nll = _dense_nll(x, t, labels, 40)
        return jnp.sum(nll) / jnp.maximum(
            jnp.sum((labels != LABEL_PAD).astype(jnp.float32)), 1.0
        )

    (lf, (gx_f, gt_f)) = jax.value_and_grad(fused_loss, argnums=(0, 1))(x, table)
    (ld, (gx_d, gt_d)) = jax.value_and_grad(dense_loss, argnums=(0, 1))(x, table)
    np.testing.assert_allclose(float(lf), float(ld), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_d), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gt_f), np.asarray(gt_d), rtol=1e-4, atol=1e-6)
    # blinded rows (reserved/OOV/padding) must receive zero table grad
    blinded = np.ones(table.shape[0], bool)
    blinded[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + 40] = False
    np.testing.assert_array_equal(np.asarray(gt_f)[blinded], 0.0)


def test_chunked_backward_matches_dense(monkeypatch):
    """A table larger than one scan tile: the forward and backward take
    several vocab chunks (the valid window crossing chunk boundaries) and
    must still match the dense oracle exactly — the path every catalog
    too large for one (N, V) tile runs. The tile budget is shrunk so the
    v=512 test table splits into four 128-row chunks."""
    from bert4clickpath.ops import fused_ce as F

    x, table, labels = _case(n=24, v=512, num_valid=400)
    monkeypatch.setattr(F, "_XLA_TILE_BYTES", 24 * 128 * 4)
    assert F._xla_chunk(512, 24) == 128

    def fused_loss(x, t):
        nll = fused_softmax_ce(x, t, labels, NUM_RESERVED_TOKENS, 400)
        return jnp.sum(nll) / jnp.maximum(
            jnp.sum((labels != LABEL_PAD).astype(jnp.float32)), 1.0
        )

    def dense_loss(x, t):
        nll = _dense_nll(x, t, labels, 400)
        return jnp.sum(nll) / jnp.maximum(
            jnp.sum((labels != LABEL_PAD).astype(jnp.float32)), 1.0
        )

    (lf, (gx_f, gt_f)) = jax.value_and_grad(fused_loss, argnums=(0, 1))(x, table)
    (ld, (gx_d, gt_d)) = jax.value_and_grad(dense_loss, argnums=(0, 1))(x, table)
    np.testing.assert_allclose(float(lf), float(ld), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_d), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gt_f), np.asarray(gt_d), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "v,n,budget,want",
    [
        (64, 16, 256 << 20, 64),  # tiny table: one chunk
        (55_296, 2_560, 256 << 20, 18_432),  # Beauty: 3 chunks under 256 MB
        (55_296, 2_560, 1 << 40, 55_296),  # budget allows the whole table
        (512, 24, 24 * 128 * 4, 128),
    ],
)
def test_xla_chunk_divides_and_fits(monkeypatch, v, n, budget, want):
    """The scan chunk divides the table, is a multiple of 128 unless it is
    the whole table, and keeps the (n, chunk) f32 tile within budget."""
    from bert4clickpath.ops import fused_ce as F

    monkeypatch.setattr(F, "_XLA_TILE_BYTES", budget)
    c = F._xla_chunk(v, n)
    assert c == want and v % c == 0 and n * c * 4 <= budget


def test_chunked_backward_bf16_accumulates_in_f32(monkeypatch):
    """With a bf16 operand dtype, dW accumulates in f32 and rounds to the
    table dtype once: several scan chunks and one whole-table chunk give
    the same gradient, and a bf16 table gets a bf16 gradient."""
    from bert4clickpath.ops import fused_ce as F

    x, table, labels = _case(n=24, v=512, num_valid=400)
    x, table = x.astype(jnp.bfloat16), table.astype(jnp.bfloat16)

    def grads(budget):
        monkeypatch.setattr(F, "_XLA_TILE_BYTES", budget)

        def loss(t):
            return jnp.sum(fused_softmax_ce(x, t, labels, NUM_RESERVED_TOKENS, 400))

        g = jax.grad(loss)(table)
        assert g.dtype == jnp.bfloat16
        return np.asarray(g, np.float32)

    g_one = grads(256 << 20)  # one chunk
    g_chunked = grads(24 * 128 * 4)  # four 128-row chunks
    np.testing.assert_allclose(g_chunked, g_one, rtol=1e-2, atol=1e-3)


def test_wrapper_matches_masked_ce():
    x, table, labels = _case(n=24)
    xb = x.reshape(8, 3, -1)
    lb = labels.reshape(8, 3)
    got = fused_masked_softmax_cross_entropy(xb, table, lb, NUM_RESERVED_TOKENS, 40)
    dense_logits = jnp.einsum(
        "bpd,vd->bpv", xb, table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + 40]
    )
    want = masked_softmax_cross_entropy(dense_logits, lb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_uneven_tiles():
    # n=8 (one tile), v=128 with valid range crossing a tile boundary
    x, table, labels = _case(n=8, d=16, v=256, num_valid=100, seed=3)
    nll = fused_softmax_ce(x, table, labels, NUM_RESERVED_TOKENS, 100)
    want = _dense_nll(x, table, labels, 100)
    np.testing.assert_allclose(np.asarray(nll), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bf16_inputs():
    x, table, labels = _case()
    nll = fused_softmax_ce(
        x.astype(jnp.bfloat16), table, labels, NUM_RESERVED_TOKENS, 40
    )
    want = _dense_nll(x.astype(jnp.bfloat16).astype(jnp.float32), table, labels, 40)
    np.testing.assert_allclose(np.asarray(nll), np.asarray(want), rtol=5e-2, atol=1e-2)


def test_sharded_fused_matches_dense():
    """sharded_fused_softmax_ce inside shard_map == dense CE (8-dev mesh)."""
    import jax
    from jax.sharding import PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from bert4clickpath.config import MeshConfig
    from bert4clickpath.ops.fused_ce import sharded_fused_softmax_ce
    from bert4clickpath.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=2, model=4))
    rng = np.random.default_rng(5)
    v, d, nv = 512, 16, 400  # 128 rows/shard
    x = jnp.asarray(rng.normal(size=(4, 8, d)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, nv, size=(4, 8)), jnp.int32)
    labels = labels.at[0, 3].set(LABEL_PAD)

    def f(x, t, lbl):
        return sharded_fused_softmax_ce(
            x, t, lbl, NUM_RESERVED_TOKENS, nv, "model", "data"
        )

    def mapped(x, t, l):
        loss, (gx, gt) = jax.value_and_grad(f, argnums=(0, 1))(x, t, l)
        # dW holds only this data-shard's batch contribution -> psum over
        # data (what a train step does before the optimizer)
        return loss, (gx, jax.lax.psum(gt, "data"))

    loss, (gx, gt) = jax.jit(
        jax.shard_map(
            mapped,
            mesh=mesh,
            in_specs=(P("data", None, None), P("model", None), P("data", None)),
            out_specs=(P(), (P("data", None, None), P("model", None))),
            check_vma=False,
        )
    )(x, table, labels)

    def dense(x, t):
        logits = jnp.einsum(
            "bpd,vd->bpv", x, t[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + nv]
        )
        from bert4clickpath.ops.losses import masked_softmax_cross_entropy

        return masked_softmax_cross_entropy(logits, labels)

    want, (wgx, wgt) = jax.value_and_grad(dense, argnums=(0, 1))(x, table)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(wgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(wgt), rtol=1e-4, atol=1e-6)


def test_oov_label_fails_loudly():
    # A label >= num_valid maps to a table row excluded from the partition
    # function; the hoisted label-pick must blind it to -1e30 (matching the
    # old in-kernel one-hot that never fired) so the nll is absurdly large,
    # not silently plausible.
    x, table, labels = _case()
    labels = labels.at[0].set(50)  # >= num_valid=40, < v=64: a real table row
    nll = fused_softmax_ce(x, table, labels, NUM_RESERVED_TOKENS, 40)
    assert float(nll[0]) > 1e20
    # the rest of the batch is unaffected
    want = _dense_nll(x, table, labels, 40)
    np.testing.assert_allclose(
        np.asarray(nll)[1:], np.asarray(want)[1:], rtol=1e-5, atol=1e-6
    )


def test_sharded_oov_label_fails_loudly():
    """Sharded path: an OOV label (>= num_valid) must blind to -1e30 and
    explode the loss, same as the single-chip path."""
    import jax
    from jax.sharding import PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from bert4clickpath.config import MeshConfig
    from bert4clickpath.ops.fused_ce import sharded_fused_softmax_ce
    from bert4clickpath.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=2, model=4))
    rng = np.random.default_rng(7)
    v, d, nv = 512, 16, 400
    x = jnp.asarray(rng.normal(size=(4, 8, d)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(v, d)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, nv, size=(4, 8)), jnp.int32)
    labels = labels.at[1, 2].set(nv + 5)  # OOV: a real table row beyond num_valid

    def f(x, t, lbl):
        return sharded_fused_softmax_ce(
            x, t, lbl, NUM_RESERVED_TOKENS, nv, "model", "data"
        )

    loss = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P("data", None, None), P("model", None), P("data", None)),
            out_specs=P(),
            check_vma=False,
        )
    )(x, table, labels)
    assert float(loss) > 1e20

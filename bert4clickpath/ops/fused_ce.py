"""Fused tied-projection softmax cross-entropy.

The single hottest op in this framework: the tied output projection
``logits = x @ E^T`` over the full catalog followed by softmax CE. Dense
logits are a ``(B*P, V)`` f32 tensor — 566 MB at Beauty scale (B=256, P=10,
V≈55k) and ~100 GB at a 10M-item catalog — read back for the softmax and
again for the backward. Here the catalog is consumed in vocab tiles with an
online (flash-attention-style) max/sum-exp, and the backward recomputes each
tile's scores instead of storing them:

  forward:  per tile: s = x @ W_j^T (+ bias), blinded; (m, l) carried online.
            The label logit is one (N, D) row-gather + row-dot outside.
  backward: recompute s, form A = dnll * (softmax - onehot), accumulate
            dx += A @ W_j and emit dW_j = A^T @ x (custom VJP).

Two implementations share that math, and :func:`_impl` picks one from the
backend: Pallas kernels through Triton on the GPU (ops/fused_ce_triton.py,
the score tiles stay in registers), and a vocab-chunked ``lax.scan`` on the
CPU (tests, the virtual-device mesh), which is also the plain reference the
kernels are checked against. :func:`forced_impl` overrides the choice for
benchmarks that race the two on the GPU.

Row blinding: tied tables hold model-space rows (reserved tokens, OOV,
divisibility padding). Rows outside [row_offset, row_offset+num_valid) get
-1e30 before the max, exactly like the sharded CE (parallel/embedding.py) —
model-space CE == label-space CE.

Interface (pure function, differentiable wrt x and table):
    nll = fused_softmax_ce(x, table, labels, row_offset, num_valid)
with x (N, D), table (V, D), labels (N,) label-space ids (may be LABEL_PAD;
those rows get nll=0), nll (N,) f32. The matmuls take their operands in
``x.dtype`` (the table is cast to it) and accumulate in f32. Masked-mean
reduction stays outside — it is O(N).
"""

from __future__ import annotations

import contextlib
import functools
import types

import jax
import jax.numpy as jnp

from bert4clickpath.constants import LABEL_PAD

NEG_BIG = -1e30


def padded_rows(v: int) -> int:
    """Smallest row count >= v that the eval/serving catalog scan
    (ops/chunked_eval.pick_chunk) accepts: a multiple of 128 up to 4096
    rows, of 1024 above, of 65536 past 1M rows. The single source of truth
    for catalog-row padding — train/eval/serving all pad through here.

    The 65536 tier keeps the scan's sequential step count low on huge
    catalogs (~150 chunks at 10M rows instead of ~2,400 at 4096-row
    chunks). The extra padding is <=0.65% of a >1M-row table and the rows
    are blinded everywhere (sharded_logits_local / chunked_scores)."""
    if v > 1_000_000:
        return v + (-v % 65536)
    return v + (-v % (1024 if v > 4096 else 128))


# -- plain XLA implementation -----------------------------------------------

# Largest (N, chunk) f32 score tile the scan holds at once.
_XLA_TILE_BYTES = 256 << 20


def _xla_chunk(v: int, n: int) -> int:
    """Rows per scan step: the fewest steps whose (n, chunk) f32 tile fits
    _XLA_TILE_BYTES, with chunk dividing v (a multiple of 128 unless the
    whole table is one chunk)."""
    for k in range(1, v + 1):
        if v % k:
            continue
        c = v // k
        if (k == 1 or c % 128 == 0) and n * c * 4 <= _XLA_TILE_BYTES:
            return c
    return v


def _xla_tiles(table, bias, chunk):
    v, d = table.shape
    k = v // chunk
    scanned = (table.reshape(k, chunk, d), jnp.arange(k, dtype=jnp.int32) * chunk)
    if bias is not None:
        scanned += (bias.reshape(k, chunk).astype(jnp.float32),)
    return scanned


def _xla_scores(x, w, b, col0, lo, hi):
    s = jax.lax.dot_general(
        x, w.astype(x.dtype), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if b is not None:
        s = s + b[None, :]
    rows = col0 + jnp.arange(w.shape[0], dtype=jnp.int32)
    valid = (rows >= lo) & (rows < hi)
    return jnp.where(valid[None, :], s, NEG_BIG), valid, rows


def _xla_fwd_stats(x, table, lo, hi, bias=None):
    n = x.shape[0]
    chunk = _xla_chunk(table.shape[0], n)

    def body(carry, scanned):
        m, l = carry
        w, col0 = scanned[:2]
        s, valid, _ = _xla_scores(x, w, scanned[2] if bias is not None else None, col0, lo, hi)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.where(valid[None, :], jnp.exp(s - m_new[:, None]), 0.0)
        return (m_new, l * jnp.exp(m - m_new) + jnp.sum(p, axis=1)), None

    init = (jnp.full((n,), NEG_BIG, jnp.float32), jnp.zeros((n,), jnp.float32))
    (m, l), _ = jax.lax.scan(body, init, _xla_tiles(table, bias, chunk))
    return m, l


def _xla_bwd(x, table, labels_local, logz, dnll, lo, hi, bias=None):
    n, d = x.shape
    chunk = _xla_chunk(table.shape[0], n)

    def body(dx, scanned):
        w, col0 = scanned[:2]
        s, valid, rows = _xla_scores(x, w, scanned[2] if bias is not None else None, col0, lo, hi)
        p = jnp.where(valid[None, :], jnp.exp(s - logz[:, None]), 0.0)
        onehot = (rows[None, :] == labels_local[:, None]).astype(jnp.float32)
        a = dnll[:, None] * (p - onehot)
        ab = a.astype(x.dtype)
        dx = dx + jax.lax.dot_general(
            ab, w.astype(x.dtype), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dw = jax.lax.dot_general(
            ab, x, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )
        return dx, (dw, jnp.sum(a, axis=0))

    dx, (dw, db) = jax.lax.scan(
        body, jnp.zeros((n, d), jnp.float32), _xla_tiles(table, bias, chunk)
    )
    v = table.shape[0]
    return dx, dw.reshape(v, d), (db.reshape(v) if bias is not None else None)


_XLA = types.SimpleNamespace(fwd_stats=_xla_fwd_stats, bwd=_xla_bwd)

IMPLS = ("triton", "xla")
_BY_BACKEND = {"gpu": "triton", "cpu": "xla"}
_forced = None


@contextlib.contextmanager
def forced_impl(name: str):
    """Trace the fused CE with ``name`` ("triton": the GPU kernels, "xla":
    the chunked scan) whatever the backend, for benchmarks that race the
    two. The choice is made when a step is traced, so build the step and
    make its first call inside the block."""
    global _forced
    if name not in IMPLS:
        raise ValueError(f"fused CE implementation {name!r} not in {IMPLS}")
    prev, _forced = _forced, name
    try:
        yield
    finally:
        _forced = prev


def _impl():
    """The implementation for the default backend: the Triton kernels on
    the GPU, the chunked scan on the CPU."""
    backend = jax.default_backend()
    name = _forced or _BY_BACKEND.get(backend)
    if name == "triton":
        from bert4clickpath.ops import fused_ce_triton

        return fused_ce_triton
    if name == "xla":
        return _XLA
    raise NotImplementedError(f"fused CE has no implementation for backend {backend!r}")


# -- dispatch points (shared by the single-device and sharded ops) -----------


def _bounds(row_start, row_offset: int, num_valid: int):
    """The valid window in this table's local row ids."""
    lo = jnp.asarray(row_offset, jnp.int32) - jnp.asarray(row_start, jnp.int32)
    return lo, lo + num_valid


def _fwd_stats(x, table, row_start, row_offset, num_valid, bias=None):
    """Online (max, sumexp) over this table's rows, each (N,) f32.

    ``row_start`` (int32 scalar, may be traced) is the global row id of
    ``table[0]`` — 0 single-device, ``shard_index * V_local`` under
    shard_map. ``bias`` (optional, (V,) f32): per-row logit bias added
    before blinding. The label logit is NOT computed here — single-device
    it is one XLA row-gather + dot (:func:`_label_logit`); the sharded tier
    gathers its local rows and psums (_sharded_fwd_impl).
    """
    lo, hi = _bounds(row_start, row_offset, num_valid)
    return _impl().fwd_stats(x, table, lo, hi, bias)


def _bwd_auto(x, table, labels_model, logz, dnll, row_offset, num_valid,
              row_start=None, bias=None):
    """(dx f32, dW in table.dtype[, db f32]) for this table's rows.

    labels_model (N,) int32 global model-space rows (-1 on pad rows).
    dW/db accumulate in f32 and round to the table dtype once. dx stays in
    f32: the sharded tier sums the shards' parts before rounding to x.dtype
    once, as one device does.
    """
    row_start = 0 if row_start is None else row_start
    lo, hi = _bounds(row_start, row_offset, num_valid)
    labels_local = labels_model - jnp.asarray(row_start, jnp.int32)
    dx, dw, db = _impl().bwd(x, table, labels_local, logz, dnll, lo, hi, bias)
    if bias is None:
        return dx, dw.astype(table.dtype)
    return dx, dw.astype(table.dtype), db


def _label_logit(x, table, labels_model, row_offset, num_valid, bias=None):
    """Label logit via one (N, D) row-gather + row-dot — the same operand
    dtype as the score tiles (x.dtype, f32 accumulation). Pad rows
    (labels_model -1) read row 0; callers mask their nll to 0. Labels
    outside [row_offset, row_offset+num_valid) are blinded to NEG_BIG: an
    OOV label yields a ~1e30 nll and fails loudly instead of silently
    gathering a row excluded from the partition function."""
    lab = jnp.maximum(labels_model, 0)
    g = jnp.einsum(
        "nd,nd->n", x, table[lab].astype(x.dtype), preferred_element_type=jnp.float32
    )
    if bias is not None:
        g = g + bias[lab]
    in_range = (labels_model >= row_offset) & (labels_model < row_offset + num_valid)
    return jnp.where(in_range, g, NEG_BIG)


def _fwd(x, table, labels_model, row_offset, num_valid, bias=None):
    m, l = _fwd_stats(x, table, 0, row_offset, num_valid, bias=bias)
    logz = m + jnp.log(l)
    return logz, _label_logit(x, table, labels_model, row_offset, num_valid, bias=bias)


# -- public custom-vjp op -------------------------------------------------


def _labels_model(labels, row_offset):
    # pad rows -> an impossible row id so the one-hot never fires
    return jnp.where(labels == LABEL_PAD, -1, labels + row_offset).astype(jnp.int32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def fused_softmax_ce(x, table, labels, row_offset: int, num_valid: int):
    """Per-row NLL of ``labels`` under softmax(x @ table^T) with row blinding.

    x: (N, D); table: (V, D); labels: (N,) label-space int32, LABEL_PAD
    allowed (those rows return 0). Returns nll (N,) f32.
    """
    nll, _ = _fused_fwd(x, table, labels, row_offset, num_valid)
    return nll


def _fused_fwd(x, table, labels, row_offset, num_valid):
    lab = _labels_model(labels, row_offset)
    logz, label_logit = _fwd(x, table, lab, row_offset, num_valid)
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    nll = (logz - label_logit) * mask
    return nll, (x, table, labels, logz)


def _fused_bwd(row_offset, num_valid, res, g):
    x, table, labels, logz = res
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    dnll = (g * mask).astype(jnp.float32)
    lab = _labels_model(labels, row_offset)
    dx, dw = _bwd_auto(x, table, lab, logz, dnll, row_offset, num_valid)
    return dx.astype(x.dtype), dw, None


fused_softmax_ce.defvjp(_fused_fwd, _fused_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def fused_softmax_ce_bias(x, table, bias, labels, row_offset: int, num_valid: int):
    """``fused_softmax_ce`` with a per-row logit bias.

    logits = x @ table^T + bias, with ``bias`` (V,) f32 aligned to the
    table's model-space rows (pad/reserved rows carry any value — they are
    blinded). Serves (a) the reference's MLP softmax head, whose final
    ``Dense(V)`` has a bias (head.py:29-47), and (b) tied heads with a free
    per-item output bias (``tied_bias``). Returns nll (N,) f32;
    differentiable wrt x, table, and bias.
    """
    nll, _ = _fused_bias_fwd(x, table, bias, labels, row_offset, num_valid)
    return nll


def _fused_bias_fwd(x, table, bias, labels, row_offset, num_valid):
    lab = _labels_model(labels, row_offset)
    b = bias.astype(jnp.float32)
    logz, label_logit = _fwd(x, table, lab, row_offset, num_valid, bias=b)
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    nll = (logz - label_logit) * mask
    return nll, (x, table, bias, labels, logz)


def _fused_bias_bwd(row_offset, num_valid, res, g):
    x, table, bias, labels, logz = res
    mask = (labels != LABEL_PAD).astype(jnp.float32)
    dnll = (g * mask).astype(jnp.float32)
    lab = _labels_model(labels, row_offset)
    dx, dw, db = _bwd_auto(
        x, table, lab, logz, dnll, row_offset, num_valid, bias=bias.astype(jnp.float32)
    )
    return dx.astype(x.dtype), dw, db.astype(bias.dtype), None


fused_softmax_ce_bias.defvjp(_fused_bias_fwd, _fused_bias_bwd)


def fused_masked_ce_sums(
    x: jnp.ndarray,  # (B, P, D)
    table: jnp.ndarray,  # (V, D) model-space rows
    labels: jnp.ndarray,  # (B, P) label-space, LABEL_PAD padded
    row_offset: int,
    num_valid: int,
    bias: jnp.ndarray | None = None,  # (V,) per-row logit bias
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(nll_sum, mask_count) on this shard — no reduction, no collectives.

    The data-parallel building block: differentiate the local sum, then psum
    grads/sums OUTSIDE autodiff (parallel/spmd.make_dp_train_step's pattern —
    collectives inside a differentiated shard_map body mis-transpose
    silently, see that module's docstring).
    """
    b, p, d = x.shape
    if bias is not None:
        nll = fused_softmax_ce_bias(
            x.reshape(b * p, d), table, bias, labels.reshape(-1),
            row_offset, num_valid,
        )
    else:
        nll = fused_softmax_ce(
            x.reshape(b * p, d), table, labels.reshape(-1), row_offset, num_valid
        )
    mask = (labels.reshape(-1) != LABEL_PAD).astype(jnp.float32)
    return jnp.sum(nll), jnp.sum(mask)


def fused_masked_softmax_cross_entropy(
    x: jnp.ndarray,  # (B, P, D)
    table: jnp.ndarray,  # (V, D) model-space rows
    labels: jnp.ndarray,  # (B, P) label-space, LABEL_PAD padded
    row_offset: int,
    num_valid: int,
    bias: jnp.ndarray | None = None,  # (V,) per-row logit bias
) -> jnp.ndarray:
    """Drop-in masked-mean CE on top of the fused op (local mean)."""
    total, count = fused_masked_ce_sums(
        x, table, labels, row_offset, num_valid, bias=bias
    )
    return total / jnp.maximum(count, 1.0)


# -- sharded variant (inside shard_map) -----------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def sharded_fused_softmax_ce(
    x,
    table_shard,
    labels,
    row_offset: int,
    num_valid: int,
    model_axis: str = "model",
    data_axis=None,
):
    """Vocab-parallel fused CE for use INSIDE ``jax.shard_map``.

    Each ``model``-shard streams its (V_local, D) rows through the fused
    op (so even a 10M-row shard never materializes (N, V_local) logits),
    then the online stats combine across shards with pmax/psum — the
    composition of this module with parallel/embedding.py's vocab-parallel
    scheme. Returns the global masked-mean CE (data-axis normalized when
    ``data_axis`` is given); gradients flow to x (psum over model) and to
    the local table shard.
    """
    loss, _ = _sharded_fwd(
        x, table_shard, labels, row_offset, num_valid, model_axis, data_axis
    )
    return loss


def _shard_row_start(table_shard, model_axis):
    idx = jax.lax.axis_index(model_axis)
    return (idx * table_shard.shape[0]).astype(jnp.int32)


def _local_bias(bias_full, row_start, v_local):
    """This shard's (V_local,) slice of the replicated model-space bias."""
    return jax.lax.dynamic_slice(bias_full.astype(jnp.float32), (row_start,), (v_local,))


def _sharded_fwd_impl(
    x, table_shard, bias_full, labels, row_offset, num_valid, model_axis, data_axis
):
    b, p, d = x.shape
    n = b * p
    xf = x.reshape(n, d)
    labf = labels.reshape(-1)
    lab_model = _labels_model(labf, row_offset)
    row_start = _shard_row_start(table_shard, model_axis)
    v_local = table_shard.shape[0]
    bloc = None if bias_full is None else _local_bias(bias_full, row_start, v_local)
    m, l = _fwd_stats(xf, table_shard, row_start, row_offset, num_valid, bias=bloc)
    gmax = jax.lax.pmax(m, model_axis)
    total = jax.lax.psum(l * jnp.exp(m - gmax), model_axis)
    logz = gmax + jnp.log(total)
    # label logit outside the kernel (as single-device): the owning shard
    # gathers its rows, everyone else contributes 0, psum assembles — the
    # embedding-lookup pattern (parallel/embedding.py)
    local = lab_model - row_start
    in_shard = (local >= 0) & (local < v_local)
    idx = jnp.clip(local, 0, v_local - 1)
    g_loc = jnp.einsum(
        "nd,nd->n", xf, table_shard[idx].astype(xf.dtype),
        preferred_element_type=jnp.float32,
    )
    if bloc is not None:
        g_loc = g_loc + bloc[idx]
    label_logit = jax.lax.psum(jnp.where(in_shard, g_loc, 0.0), model_axis)
    # blind labels outside [row_offset, row_offset+num_valid) — same loud
    # OOV failure as _label_logit
    in_range = (lab_model >= row_offset) & (lab_model < row_offset + num_valid)
    label_logit = jnp.where(in_range, label_logit, NEG_BIG)
    mask = (labf != LABEL_PAD).astype(jnp.float32)
    total_loss = jnp.sum((logz - label_logit) * mask)
    count = jnp.sum(mask)
    if data_axis is not None:
        total_loss = jax.lax.psum(total_loss, data_axis)
        count = jax.lax.psum(count, data_axis)
    count = jnp.maximum(count, 1.0)
    loss = total_loss / count
    return loss, (x, table_shard, bias_full, labels, logz, count)


def _sharded_bwd_impl(row_offset, num_valid, model_axis, data_axis, res, gbar):
    x, table_shard, bias_full, labels, logz, count = res
    b, p, d = x.shape
    n = b * p
    labf = labels.reshape(-1)
    mask = (labf != LABEL_PAD).astype(jnp.float32)
    dnll = (gbar / count) * mask  # (n,) d(loss)/d(nll_i)
    lab_model = _labels_model(labf, row_offset)
    row_start = _shard_row_start(table_shard, model_axis)
    bloc = (
        None
        if bias_full is None
        else _local_bias(bias_full, row_start, table_shard.shape[0])
    )
    outs = _bwd_auto(
        x.reshape(n, d),
        table_shard,
        lab_model,
        logz,
        dnll.astype(jnp.float32),
        row_offset,
        num_valid,
        row_start=row_start,
        bias=bloc,
    )
    # each shard's dx covers only its vocab rows' contribution: summed in
    # f32, rounded once
    dx = jax.lax.psum(outs[0], model_axis).astype(x.dtype)
    dw = outs[1]
    if bias_full is None:
        return dx.reshape(b, p, d), dw
    # bias_full is REPLICATED: scatter this shard's db into its row window
    # and psum so every shard returns the complete gradient. The psum lives
    # in this hand-written VJP — never autodiffed through.
    db_full = jax.lax.dynamic_update_slice(
        jnp.zeros_like(bias_full, dtype=jnp.float32), outs[2], (row_start,)
    )
    db_full = jax.lax.psum(db_full, model_axis).astype(bias_full.dtype)
    return dx.reshape(b, p, d), dw, db_full


def _sharded_fwd(x, table_shard, labels, row_offset, num_valid, model_axis, data_axis):
    loss, res = _sharded_fwd_impl(
        x, table_shard, None, labels, row_offset, num_valid, model_axis, data_axis
    )
    x, table_shard, _, labels, logz, count = res
    return loss, (x, table_shard, labels, logz, count)


def _sharded_bwd(row_offset, num_valid, model_axis, data_axis, res, gbar):
    x, table_shard, labels, logz, count = res
    dx, dw = _sharded_bwd_impl(
        row_offset, num_valid, model_axis, data_axis,
        (x, table_shard, None, labels, logz, count), gbar,
    )
    return dx, dw, None


sharded_fused_softmax_ce.defvjp(_sharded_fwd, _sharded_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def sharded_fused_softmax_ce_bias(
    x,
    table_shard,
    bias_full,
    labels,
    row_offset: int,
    num_valid: int,
    model_axis: str = "model",
    data_axis=None,
):
    """``sharded_fused_softmax_ce`` with a replicated model-space bias.

    ``bias_full`` is the FULL (V_total,) model-space per-row bias, replicated
    on every shard (it is small — one f32 per catalog row); each shard
    slices its own row window. The VJP returns the complete psum'd bias
    gradient on every shard, so a replicated bias param (e.g. the tied
    head's ``tied_out_bias``) trains correctly under vocab sharding.
    """
    loss, _ = _sharded_bias_fwd(
        x, table_shard, bias_full, labels, row_offset, num_valid,
        model_axis, data_axis,
    )
    return loss


def _sharded_bias_fwd(
    x, table_shard, bias_full, labels, row_offset, num_valid, model_axis, data_axis
):
    return _sharded_fwd_impl(
        x, table_shard, bias_full, labels, row_offset, num_valid,
        model_axis, data_axis,
    )


def _sharded_bias_bwd(row_offset, num_valid, model_axis, data_axis, res, gbar):
    dx, dw, db = _sharded_bwd_impl(
        row_offset, num_valid, model_axis, data_axis, res, gbar
    )
    return dx, dw, db, None


sharded_fused_softmax_ce_bias.defvjp(_sharded_bias_fwd, _sharded_bias_bwd)

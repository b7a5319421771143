"""Fused tied-projection softmax CE as Pallas kernels for the GPU (Triton).

The scores ``s = x @ W^T`` of a (N, D) activation against a (V, D) catalog
never reach device memory: each program keeps a (TN, TV) score tile in
registers and folds it into what it owes.

* forward — grid (row tiles, vocab splits). A program loops over the vocab
  tiles of its split with an online (max, sum-exp) in registers and writes
  one (m, l) pair per row; the splits are merged in XLA with the same
  max-and-rescale the vocab-sharded tier uses across devices.
* dx — grid (row tiles, vocab splits). A program recomputes its rows'
  scores over its split, forms ``A = dnll * (softmax - onehot)`` and
  accumulates ``A @ W`` in f32; the per-split partial sums are added in XLA.
* dW (+ db) — grid (vocab tiles,). A program owns one vocab tile and loops
  over every row tile, accumulating ``A^T @ x``, so no sum crosses programs.

No atomics: every sum is taken in a fixed order. Operands are in the
activation dtype (bf16 for the flagship) with f32 accumulation; float32
operands multiply in TF32, as XLA's float32 dots do on the GPU, unless
``jax.default_matmul_precision`` asks for full float32 products (``pl.dot``
takes its precision from that setting when a step is traced). Rows of
the table outside the valid window ``[lo, hi)`` (reserved tokens, OOV,
padding, other shards' labels) are blinded before the max.

The shapes a kernel sees are padded here: rows to a multiple of the row
tile, table rows to a multiple of the vocab tile, D to a power of two.
Padding rows carry ``dnll = 0`` and padded table rows sit outside the valid
window, so neither changes a result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_BIG = -1e30

# Tiles (powers of two) and launch shapes: the fastest of a sweep on an
# H100 SXM (400 W limit) at the flagship width (N=2,560, D=256, 55,296
# table rows). A (128, 128) forward tile with 3 stages overflows the 227 KiB
# of shared memory per block.
FWD_TN, FWD_TV, FWD_WARPS, FWD_STAGES = 128, 64, 8, 4
DX_TN, DX_TV, DX_WARPS, DX_STAGES = 128, 64, 8, 2
DW_TN, DW_TV, DW_WARPS, DW_STAGES = 128, 64, 8, 2
# Enough programs for two waves on the card's 132 SMs.
TARGET_PROGRAMS = 264
# Shared memory per block on the H100 (227 KiB). A kernel holds its fixed
# operand block plus ``stages`` copies of the tile its loop streams
# (Triton's software pipelining), in the operand dtype.
SMEM_BYTES = 232_448


def _splits(row_tiles: int, vocab_tiles: int) -> int:
    """Largest divisor of ``vocab_tiles`` that keeps row_tiles * splits
    near TARGET_PROGRAMS: row tiles alone under-fill the card at N~2.5k."""
    want = max(1, -(-TARGET_PROGRAMS // row_tiles))
    best = 1
    for s in range(1, min(want, vocab_tiles) + 1):
        if vocab_tiles % s == 0:
            best = s
    return best


def _fit(fixed: int, streamed: int, stages: int, dp: int, itemsize: int):
    """(fixed, streamed, stages) shrunk until the operand buffers fit
    SMEM_BYTES: fewer stages (down to 2), then a halved streamed tile, then
    a halved fixed tile (down to 16 rows each), then one stage. The tuned
    bf16 tiles at D=256 fit as they are; float32 operands or a wider D
    shrink them."""

    def need(f, s, st):
        return (f + st * s) * dp * itemsize

    while need(fixed, streamed, stages) > SMEM_BYTES:
        if stages > 2:
            stages -= 1
        elif streamed > 16:
            streamed //= 2
        elif fixed > 16:
            fixed //= 2
        elif stages > 1:
            stages -= 1
        else:
            break
    return fixed, streamed, stages


def _width(d: int) -> int:
    return max(16, pl.next_power_of_2(d))


def _pad_to(a: jnp.ndarray, axis: int, size: int, value=0) -> jnp.ndarray:
    extra = size - a.shape[axis]
    if extra == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, extra)
    return jnp.pad(a, widths, constant_values=value)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _prep(x, table, bias, tn, tv):
    """Pad rows/D/table rows and cast the table to the operand dtype."""
    n, d = x.shape
    dp = _width(d)
    vp = _round_up(table.shape[0], tv)
    xp = _pad_to(_pad_to(x, 1, dp), 0, _round_up(n, tn))
    wp = _pad_to(_pad_to(table.astype(x.dtype), 1, dp), 0, vp)
    bp = None if bias is None else _pad_to(bias.reshape(-1).astype(jnp.float32), 0, vp)
    return xp, wp, bp


def _scores(x, w, b_ref, col0, tv, lo, hi):
    """(TN, TV) f32 blinded scores of a row tile against vocab tile col0."""
    s = pl.dot(x, w, trans_b=True)
    if b_ref is not None:
        s = s + b_ref[pl.ds(col0, tv)][None, :]
    rows = col0 + jnp.arange(tv, dtype=jnp.int32)
    valid = (rows >= lo) & (rows < hi)
    return jnp.where(valid[None, :], s, NEG_BIG), valid, rows


# -- forward ---------------------------------------------------------------


def _fwd_kernel(bounds_ref, x_ref, w_ref, *rest, tv, tiles_per_split, has_bias):
    b_ref = rest[0] if has_bias else None
    m_ref, l_ref = rest[-2:]
    lo, hi = bounds_ref[0], bounds_ref[1]
    split = pl.program_id(1)
    x = x_ref[...]
    tn = x.shape[0]

    def body(t, carry):
        m, l = carry
        col0 = (split * tiles_per_split + t) * tv
        s, valid, _ = _scores(x, w_ref[pl.ds(col0, tv), :], b_ref, col0, tv, lo, hi)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.where(valid[None, :], jnp.exp(s - m_new[:, None]), 0.0)
        return m_new, l * jnp.exp(m - m_new) + jnp.sum(p, axis=1)

    m, l = jax.lax.fori_loop(
        0, tiles_per_split, body,
        (jnp.full((tn,), NEG_BIG, jnp.float32), jnp.zeros((tn,), jnp.float32)),
    )
    m_ref[...] = m
    l_ref[...] = l


def fwd_stats(x, table, lo, hi, bias=None, interpret: bool = False):
    """Per-row (max, sum-exp) of the blinded scores over all table rows.

    x (N, D); table (V, D); valid table rows are ``[lo, hi)`` (int32
    scalars, may be traced); bias (V,) f32 or None. Returns (m, l), (N,) f32.
    """
    n = x.shape[0]
    tn, tv, stages = _fit(FWD_TN, FWD_TV, FWD_STAGES, _width(x.shape[1]), x.dtype.itemsize)
    xp, wp, bp = _prep(x, table, bias, tn, tv)
    row_tiles, vocab_tiles = xp.shape[0] // tn, wp.shape[0] // tv
    splits = _splits(row_tiles, vocab_tiles)
    kernel = functools.partial(
        _fwd_kernel, tv=tv, tiles_per_split=vocab_tiles // splits,
        has_bias=bp is not None,
    )
    in_specs = [
        pl.no_block_spec,
        pl.BlockSpec((tn, xp.shape[1]), lambda i, s: (i, 0)),
        pl.no_block_spec,
    ]
    operands = [jnp.stack([lo, hi]).astype(jnp.int32), xp, wp]
    if bp is not None:
        in_specs.append(pl.no_block_spec)
        operands.append(bp)
    stat = jax.ShapeDtypeStruct((splits, xp.shape[0]), jnp.float32)
    m, l = pl.pallas_call(
        kernel,
        grid=(row_tiles, splits),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((None, tn), lambda i, s: (s, i))] * 2,
        out_shape=[stat, stat],
        compiler_params=plgpu.CompilerParams(num_warps=FWD_WARPS, num_stages=stages),
        backend="triton",
        interpret=interpret,
        name="fused_ce_fwd",
    )(*operands)
    # merge the vocab splits: global max, rescaled sums
    gm = jnp.max(m, axis=0)
    gl = jnp.sum(l * jnp.exp(m - gm[None]), axis=0)
    return gm[:n], gl[:n]


# -- backward --------------------------------------------------------------


def _adjoint(s, valid, rows, lab, logz, dnll):
    """A = dnll * (softmax - onehot) for one (TN, TV) tile."""
    p = jnp.where(valid[None, :], jnp.exp(s - logz[:, None]), 0.0)
    onehot = (rows[None, :] == lab[:, None]).astype(jnp.float32)
    return dnll[:, None] * (p - onehot)


def _dx_kernel(bounds_ref, x_ref, w_ref, *rest, tv, tiles_per_split, has_bias):
    b_ref = rest[0] if has_bias else None
    lab_ref, logz_ref, dnll_ref, dx_ref = rest[-4:]
    lo, hi = bounds_ref[0], bounds_ref[1]
    split = pl.program_id(1)
    x = x_ref[...]
    lab, logz, dnll = lab_ref[...], logz_ref[...], dnll_ref[...]

    def body(t, acc):
        col0 = (split * tiles_per_split + t) * tv
        w = w_ref[pl.ds(col0, tv), :]
        s, valid, rows = _scores(x, w, b_ref, col0, tv, lo, hi)
        a = _adjoint(s, valid, rows, lab, logz, dnll)
        return acc + pl.dot(a.astype(x.dtype), w)

    dx_ref[...] = jax.lax.fori_loop(
        0, tiles_per_split, body, jnp.zeros(x.shape, jnp.float32)
    )


def _dw_kernel(bounds_ref, x_ref, w_ref, *rest, tn, tv, row_tiles, has_bias):
    if has_bias:
        b_ref, lab_ref, logz_ref, dnll_ref, dw_ref, db_ref = rest
    else:
        (lab_ref, logz_ref, dnll_ref, dw_ref), b_ref, db_ref = rest, None, None
    lo, hi = bounds_ref[0], bounds_ref[1]
    col0 = pl.program_id(0) * tv
    w = w_ref[...]

    def body(r, carry):
        dw, db = carry
        rs = pl.ds(r * tn, tn)
        x = x_ref[rs, :]
        s, valid, rows = _scores(x, w, b_ref, col0, tv, lo, hi)
        a = _adjoint(s, valid, rows, lab_ref[rs], logz_ref[rs], dnll_ref[rs])
        dw = dw + pl.dot(a.astype(x.dtype), x, trans_a=True)
        return dw, db + jnp.sum(a, axis=0)

    dw, db = jax.lax.fori_loop(
        0, row_tiles, body,
        (jnp.zeros(w.shape, jnp.float32), jnp.zeros((tv,), jnp.float32)),
    )
    dw_ref[...] = dw
    if db_ref is not None:
        db_ref[...] = db


def bwd(x, table, labels_local, logz, dnll, lo, hi, bias=None, interpret: bool = False):
    """(dx f32 (N, D), dW f32 (V, D), db f32 (V,) or None).

    labels_local (N,) int32: the label's row in this table (anything
    outside ``[0, V)`` never matches); logz (N,) f32 from the forward;
    dnll (N,) f32 = d loss / d nll per row (0 on pad rows).
    """
    n, d = x.shape
    v = table.shape[0]
    has_bias = bias is not None
    bounds = jnp.stack([lo, hi]).astype(jnp.int32)
    common = dict(has_bias=has_bias)

    # dx: (row tiles, vocab splits), partial sums over splits added in XLA
    dp, itemsize = _width(d), x.dtype.itemsize
    tn, tv, stages = _fit(DX_TN, DX_TV, DX_STAGES, dp, itemsize)
    xp, wp, bp = _prep(x, table, bias, tn, tv)
    np_, dp = xp.shape
    row_tiles, vocab_tiles = np_ // tn, wp.shape[0] // tv
    splits = _splits(row_tiles, vocab_tiles)
    row_ops = [
        _pad_to(labels_local.astype(jnp.int32), 0, np_, -1),
        _pad_to(logz.astype(jnp.float32), 0, np_),
        _pad_to(dnll.astype(jnp.float32), 0, np_),
    ]
    in_specs = [pl.no_block_spec, pl.BlockSpec((tn, dp), lambda i, s: (i, 0)), pl.no_block_spec]
    operands = [bounds, xp, wp]
    if has_bias:
        in_specs.append(pl.no_block_spec)
        operands.append(bp)
    in_specs += [pl.BlockSpec((tn,), lambda i, s: (i,))] * 3
    dx_parts = pl.pallas_call(
        functools.partial(
            _dx_kernel, tv=tv, tiles_per_split=vocab_tiles // splits, **common
        ),
        grid=(row_tiles, splits),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((None, tn, dp), lambda i, s: (s, i, 0)),
        out_shape=jax.ShapeDtypeStruct((splits, np_, dp), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=DX_WARPS, num_stages=stages),
        backend="triton",
        interpret=interpret,
        name="fused_ce_dx",
    )(*operands, *row_ops)
    dx = jnp.sum(dx_parts, axis=0)[:n, :d]

    # dW (+ db): one program per vocab tile, looping over every row tile
    tv, tn, stages = _fit(DW_TV, DW_TN, DW_STAGES, dp, itemsize)
    xp, wp, bp = _prep(x, table, bias, tn, tv)
    np_, dp = xp.shape
    vp = wp.shape[0]
    row_ops = [
        _pad_to(labels_local.astype(jnp.int32), 0, np_, -1),
        _pad_to(logz.astype(jnp.float32), 0, np_),
        _pad_to(dnll.astype(jnp.float32), 0, np_),
    ]
    in_specs = [pl.no_block_spec, pl.no_block_spec, pl.BlockSpec((tv, dp), lambda j: (j, 0))]
    operands = [bounds, xp, wp]
    if has_bias:
        in_specs.append(pl.no_block_spec)
        operands.append(bp)
    in_specs += [pl.no_block_spec] * 3
    out_specs = [pl.BlockSpec((tv, dp), lambda j: (j, 0))]
    out_shape = [jax.ShapeDtypeStruct((vp, dp), jnp.float32)]
    if has_bias:
        out_specs.append(pl.BlockSpec((tv,), lambda j: (j,)))
        out_shape.append(jax.ShapeDtypeStruct((vp,), jnp.float32))
    outs = pl.pallas_call(
        functools.partial(_dw_kernel, tn=tn, tv=tv, row_tiles=np_ // tn, **common),
        grid=(vp // tv,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=DW_WARPS, num_stages=stages),
        backend="triton",
        interpret=interpret,
        name="fused_ce_dw",
    )(*operands, *row_ops)
    dw = outs[0][:v, :d]
    db = outs[1][:v] if has_bias else None
    return dx, dw, db

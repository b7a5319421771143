"""Smoke test of the flagship train-and-serve path on the GPU.

``python chip_smoke.py`` (one card), in one process, in order:

1. device — the default JAX device must be a GPU; prints the card's name
   and power limit as nvidia-smi reports them;
2. ce — the shipped fused CE (the Triton kernels on the GPU) at Beauty
   widths: x (2,560, 256) against the padded 55,296-row table, with pad
   labels and an out-of-catalog label, loss/dx/dtable(/dbias) against a
   dense float32 reference computed at ``highest`` matmul precision: bf16
   operands with and without ``tied_bias``, float32 operands at the
   default precision (TF32) and at ``highest``;
3. attention — cuDNN flash attention (the encoder's choice on the GPU for
   bf16) against the per-head XLA path at L=53 and L=512, outputs and
   gradients, with padded keys and a session that is all padding;
4. train — examples/bert4rec/train.py ``main()`` on the flagship preset
   over the 54,542-item simulated catalog for one short epoch: the loss is
   finite and falls, a checkpoint and the serving export are written;
5. serve — ``ServingModel`` loads that export and answers requests: k
   distinct items per session, finite scores, and top-1 equal to the
   argmax of the full-catalog scores of the same session.

``python chip_smoke.py --four`` (four cards) runs only the multi-device
paths, each beside its one-card twin:

* dp — train.py ``--parallel dp`` over the 4 cards against ``--parallel
  none`` on one card, same global batch and seed, dropout off;
* spmd — ``spmd.make_spmd_train_step`` on a (data=1, model=4) mesh (the
  vocab-sharded fused CE inside shard_map) against the one-card train step
  on the same batch, over several seeds: loss, and parameter updates held
  to a noise witness from the same run (float32 at "highest": the
  one-card step compiled under remat; bfloat16: the one-card bf16 step's
  distance from the float32 one).

Any failed check raises, and the script exits non-zero. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))

# Flagship widths (BASELINE.json configs[1]; bench.py) and the Beauty catalog.
N_ITEMS = 54_542
BATCH = 256
MAX_MASKED = 10
D_MODEL = 256


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _train_module():
    spec = importlib.util.spec_from_file_location(
        "bert4rec_train", os.path.join(REPO, "examples", "bert4rec", "train.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _history(model_dir: str) -> list[dict]:
    with open(os.path.join(model_dir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- phases -------------------------------------------------------------------


def phase_device(n_devices: int) -> None:
    import jax

    from bert4clickpath.utils.device import card_line

    devs = jax.devices()
    _check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform!r}")
    _check(len(devs) >= n_devices, f"needs {n_devices} GPUs, found {len(devs)}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}", flush=True)


# (operand dtype, tied_bias, matmul precision, loss tolerance, gradient
# tolerance). bf16 operands multiply exactly with f32 accumulation, but the
# kernels round the softmax adjoint to bf16 before the dx/dW products (~3
# significant digits). float32 operands multiply in TF32 by default (10
# mantissa bits) and in full float32 under "highest", where only the
# summation order differs from the reference.
CE_CASES = (
    ("bfloat16", False, None, 1e-3, 2e-2),
    ("bfloat16", True, None, 1e-3, 2e-2),
    ("float32", False, None, 1e-3, 2e-2),
    ("float32", False, "highest", 1e-5, 1e-4),
)


def phase_ce(n_items: int = N_ITEMS, rows: int = BATCH * MAX_MASKED, d: int = D_MODEL) -> None:
    """Shipped fused CE vs a dense f32 reference at real widths, one case
    per entry of CE_CASES. The reference takes the same operand values in
    float32 at "highest" precision; errors are relative to the largest
    entry of each gradient."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS as OFF
    from bert4clickpath.ops import fused_ce
    from bert4clickpath.parallel.spmd import padded_vocab_rows

    v = padded_vocab_rows(n_items + OFF + 1, 1)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(rows, d)), jnp.bfloat16)
    table = jnp.asarray(rng.normal(size=(v, d)) / np.sqrt(d), jnp.float32)
    bias = jnp.asarray(rng.normal(size=(v,)), jnp.float32)
    labels = rng.integers(0, n_items, size=(rows,)).astype(np.int32)
    labels[::9] = LABEL_PAD
    oov = 3
    labels[oov] = n_items + 2  # a padding row of the table: blinded, must explode
    labels = jnp.asarray(labels)
    real = (labels != LABEL_PAD) & (labels < n_items)
    # the out-of-catalog row gets weight 0, so its ~1e30 nll leaves the
    # compared loss and gradients alone
    weight = real.astype(jnp.float32) / jnp.sum(real)

    def shipped(x, t, b, with_bias):
        if with_bias:
            nll = fused_ce.fused_softmax_ce_bias(x, t, b, labels, OFF, n_items)
        else:
            nll = fused_ce.fused_softmax_ce(x, t, labels, OFF, n_items)
        return jnp.sum(nll * weight), nll

    def dense(x, t, b, with_bias):
        with jax.default_matmul_precision("highest"):
            w = t.astype(x.dtype).astype(jnp.float32)
            logits = x.astype(jnp.float32) @ w.T
            if with_bias:
                logits = logits + b
            rows_ = jnp.arange(v)
            valid = (rows_ >= OFF) & (rows_ < OFF + n_items)
            logits = jnp.where(valid, logits, -1e30)
            lab = jnp.where(labels == LABEL_PAD, 0, labels + OFF)
            pick = jnp.take_along_axis(logits, lab[:, None], axis=1)[:, 0]
            nll = (jax.nn.logsumexp(logits, axis=1) - pick) * (labels != LABEL_PAD)
            return jnp.sum(nll * weight), nll

    def grad(f):
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True), static_argnums=3)

    for dtype, with_bias, precision, loss_tol, grad_tol in CE_CASES:
        args = (x.astype(dtype), table, bias, with_bias)
        ctx = jax.default_matmul_precision(precision) if precision else contextlib.nullcontext()
        with ctx:
            (got, nll), g_got = grad(shipped)(*args)
        (want, _), g_want = grad(dense)(*args)
        errs = {"loss": abs(float(got) - float(want)) / abs(float(want))}
        names = ("dx", "dtable", "dbias") if with_bias else ("dx", "dtable")
        for name, a, b in zip(names, g_got, g_want):
            errs[name] = _rel_err(a, b)
        print(json.dumps({
            "phase": "ce", "operands": dtype, "tied_bias": with_bias,
            "precision": precision or "default", "shape": [rows, d, v], "max_err": errs,
            "tolerance": {"loss": loss_tol, "grads": grad_tol},
        }), flush=True)
        _check(errs["loss"] <= loss_tol, f"CE loss error {errs['loss']}")
        for name in names:
            _check(errs[name] <= grad_tol, f"CE {name} error {errs[name]}")
        _check(float(nll[oov]) > 1e20, "out-of-catalog label did not blind")
        _check(bool(jnp.all(nll[labels == LABEL_PAD] == 0)), "pad rows must give nll 0")


def phase_attention(batch: int = 32, d: int = D_MODEL, heads: int = 4) -> None:
    """cuDNN flash attention vs the per-head XLA path, bf16, at the
    flagship's L=53 (odd: cuDNN runs it padded to 54) and at L=512, with
    padded keys in every session and one session that is all padding
    (``padding_bias`` gives that one a zero bias on every key).

    Tolerance: 2e-2 of the largest entry of each output and gradient, every
    session included. Both paths multiply bf16 operands with f32
    accumulation but round the softmax probabilities to bf16 at different
    points.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath.constants import PAD_ID
    from bert4clickpath.models.encoder import attention_cudnn, attention_per_head
    from bert4clickpath.ops.masking import padding_bias

    tol = 2e-2
    for length in (53, 512):
        rng = np.random.default_rng(length)
        q, k, v, ct = (
            jnp.asarray(rng.normal(size=(batch, length, d)), jnp.bfloat16) for _ in range(4)
        )
        tokens = np.full((batch, length), PAD_ID + 20, np.int32)
        real = rng.integers(1, length + 1, size=batch)
        tokens[np.arange(length)[None, :] >= real[:, None]] = PAD_ID
        tokens[0] = PAD_ID  # a session that is all padding
        bias = padding_bias(jnp.asarray(tokens))

        def run(fn):
            def f(q, k, v):
                return fn(q, k, v, bias, heads)

            out, vjp = jax.vjp(f, q, k, v)
            return (out, *vjp(ct))

        got = jax.jit(lambda: run(attention_cudnn))()
        want = jax.jit(lambda: run(attention_per_head))()
        names = ("out", "dq", "dk", "dv")
        errs = {n: _rel_err(a, b) for n, a, b in zip(names, got, want)}
        padded = {n: _rel_err(a[:1], b[:1]) for n, a, b in zip(names, got, want)}
        finite = all(bool(jnp.all(jnp.isfinite(a.astype(jnp.float32)))) for a in got)
        print(json.dumps({
            "phase": "attention", "L": length, "shape": [batch, length, d], "heads": heads,
            "max_err": errs, "all_padding_session_err": padded, "tolerance": tol,
            "finite": finite, "reason": "bf16 operands and probabilities, f32 accumulation",
        }), flush=True)
        _check(finite, f"cuDNN attention not finite at L={length}")
        for n in names:
            _check(errs[n] <= tol, f"cuDNN attention {n} error {errs[n]} at L={length}")
            _check(padded[n] <= tol,
                   f"cuDNN attention {n} error {padded[n]} on the all-padding session")


def phase_train(model_dir: str, n_items: int = N_ITEMS, batch: int = BATCH,
                steps: int = 8, extra: tuple = ()) -> dict:
    """One short flagship epoch through train.py's main()."""
    from bert4clickpath.training import checkpoint as ckpt_lib

    train = _train_module()
    train.main([
        "--simulated", "--n_items", str(n_items), "--n_sessions", str(8 * batch),
        "--preset", "flagship", "--batch", str(batch),
        "--steps_per_epoch", str(steps), "--epochs", "1", "--eval_batches", "2",
        "--model_dir", model_dir, *extra,
    ])
    rec = _history(model_dir)[-1]
    print(json.dumps({"phase": "train", **rec}), flush=True)
    first, last = rec["train_loss_first"], rec["train_loss_last"]
    _check(all(map(lambda v: v == v and abs(v) < 1e30, (first, last))), "loss not finite")
    _check(last < first, f"loss did not fall: first {first}, last {last}")
    _check(ckpt_lib.latest_checkpoint(os.path.join(model_dir, "ckpts")) is not None,
           "no checkpoint written")
    _check(os.path.exists(os.path.join(model_dir, "export", "params", "manifest.json")),
           "no serving export written")
    return rec


def phase_serve(model_dir: str, k: int = 10) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath.constants import NUM_RESERVED_TOKENS
    from bert4clickpath.models.model import head_catalog
    from bert4clickpath.training.serving import ServingModel

    served = ServingModel(os.path.join(model_dir, "export"), warmup_batches=(1, 8))
    vocab = served.vocabs[served._item_feature]
    rng = np.random.default_rng(1)
    items = [vocab.decode_label(int(i)) for i in rng.integers(0, vocab.label_vocab_size, 64)]
    sessions = [items[i * 7 : i * 7 + 3 + i] for i in range(5)]
    recs = served.recommend(sessions, k=k)
    feats, pos = served.encode(sessions)
    x = served.model.apply(
        served.params, feats, pos, method="gather_head_inputs"
    )[: len(sessions), 0]
    table, bias, _, _ = head_catalog(served.config, served.params)
    v = served.config.head.output_size
    with jax.default_matmul_precision("highest"):
        scores = x @ table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + v].T
    if bias is not None:
        scores = scores + bias[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + v]
    scores = np.asarray(scores, np.float32)
    for i, rec in enumerate(recs):
        names = [n for n, _ in rec]
        vals = np.asarray([s for _, s in rec])
        _check(len(set(names)) == k, f"session {i}: {k} distinct items expected")
        _check(bool(np.all(np.isfinite(vals))), f"session {i}: non-finite scores")
        best = int(np.argmax(scores[i]))
        top1 = int(vocab.encode_labels([names[0]])[0])
        # equal, or an exact tie at the float precision of the scan
        _check(top1 == best or scores[i, top1] >= scores[i, best] - 1e-4 * abs(scores[i, best]),
               f"session {i}: top-1 {top1} != catalog argmax {best}")
    print(json.dumps({"phase": "serve", "sessions": len(recs), "k": k,
                      "top1": [r[0][0] for r in recs]}), flush=True)


def phase_dp_vs_single(root: str, n_items: int = N_ITEMS, batch: int = BATCH,
                       steps: int = 4, tol: float = 5e-3) -> None:
    """train.py --parallel dp over every card vs --parallel none on one.

    Tolerance ``tol`` relative on each logged loss: the same bf16 program,
    but each card multiplies 64-row blocks where one card multiplies
    256-row ones (other GEMM kernels, other summation orders), and the
    gradient is summed over 4 shards; the rounding differences compound
    over the steps."""
    common = ("--dropout", "0", "--eval_batch", str(batch))
    one = phase_train(os.path.join(root, "one"), n_items, batch, steps,
                      ("--parallel", "none", *common))
    dp = phase_train(os.path.join(root, "dp"), n_items, batch, steps,
                     ("--parallel", "dp", *common))
    errs = {
        key: abs(dp[key] - one[key]) / abs(one[key])
        for key in ("train_loss_first", "train_loss", "train_loss_last", "val_loss")
    }
    print(json.dumps({"phase": "dp_vs_single", "rel_err": errs, "tolerance": tol}), flush=True)
    for key, err in errs.items():
        _check(err <= tol, f"dp {key} differs from one card by {err}")


# Vocab-sharded step vs one card, over several seeds. Each dtype is held to
# a noise witness measured in the same run, and SPMD_FACTOR gives the room.
# float32 at "highest": a second compilation of the same math on one card
# (the one-card step under remat) moves the worst leaf's update by 1e-3 to
# 7e-3 of its largest entry on an H100 (ReLU masks flip where two programs
# round a pre-activation near 0 differently); two runs of one program agree
# to ~1e-6 and the Triton and scan CE to ~3e-5, so SPMD_F32_FLOOR bounds the
# witness from below. bfloat16: one card's bf16 updates are 0.09-0.13 from
# its float32 ones; the sharded bf16 updates are held to their distance from
# the float32 one-card updates.
SPMD_SEEDS = (0, 1, 2)
SPMD_FACTOR = 2.0
SPMD_F32_LOSS_TOL, SPMD_BF16_LOSS_TOL = 1e-5, 1e-3
SPMD_F32_FLOOR = 1e-4


def _worst_leaf(got, want) -> tuple[float, str]:
    """(largest per-leaf error relative to the leaf's largest entry, leaf)."""
    import jax
    import numpy as np

    errs = {
        jax.tree_util.keystr(path): _rel_err(a, b)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want))
        if np.abs(b).max() > 0
    }
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def spmd_steps(n_items: int = N_ITEMS, batch: int = BATCH, shards: int = 4):
    """A function ``run(seed, dtype, program) -> (loss, updates)``: one
    train step of the flagship (dropout off, plain SGD at lr 1, so the
    parameter updates are the gradients) as ``program``: "single" (one
    card), "remat" (one card, each layer under ``jax.checkpoint``: the same
    math compiled differently) or "sharded" (a (data=1, model=``shards``)
    mesh with the vocab-sharded fused CE). Each step program is built once
    and reused across seeds; float32 runs at "highest" matmul precision."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import bench
    from bert4clickpath import ClickstreamModel, FeatureConfig, MeshConfig
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.data.pipeline import ClozeDataset
    from bert4clickpath.parallel import spmd
    from bert4clickpath.parallel.mesh import make_mesh
    from bert4clickpath.training import schedules
    from bert4clickpath.training.train_state import TrainState, make_train_step

    tx = optax.scale(-1.0)  # SGD: the update IS lr * gradient
    sched = schedules.constant(1.0)
    mesh = make_mesh(MeshConfig(data=1, model=shards), jax.devices()[:shards])
    cache = {}

    def build(dtype, vocab):
        cfg = dataclasses.replace(
            bench.flagship_config(vocab), dropout_rate=0.0, dtype=dtype,
            features={"items": FeatureConfig(
                spmd.padded_vocab_rows(vocab.model_vocab_size, shards), D_MODEL)},
        )
        model = ClickstreamModel(cfg)
        steps = {
            name: make_train_step(ClickstreamModel(cfg, remat=name == "remat"), tx, sched,
                                  donate=False, fused_ce_num_valid=vocab.label_vocab_size)
            for name in ("single", "remat")
        }
        steps["sharded"] = spmd.make_spmd_train_step(cfg, mesh, tx, sched, vocab.label_vocab_size)
        return cfg, model, steps

    def run(seed: int, dtype: str, program: str):
        gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=seed)
        vocab = gen.item_vocab()
        if dtype not in cache:
            cache[dtype] = build(dtype, vocab)
        cfg, model, steps = cache[dtype]
        items, _ = gen.generate_sessions(batch * 2)
        ds = ClozeDataset(items, vocab, max_items=cfg.max_len - 3)
        b = next(ds.train_batches(batch, seed=seed))
        batch_d = {
            "features": {k: jnp.asarray(v) for k, v in b.features.items()},
            "head_positions": jnp.asarray(b.head_positions),
            "labels": jnp.asarray(b.labels),
        }
        params = model.init(jax.random.PRNGKey(seed), batch_d["features"], batch_d["head_positions"])
        host0 = jax.device_get(params)["params"]
        rng = jax.random.PRNGKey(seed + 1)
        precision = (jax.default_matmul_precision("highest") if dtype == "float32"
                     else contextlib.nullcontext())
        with precision:
            if program == "sharded":
                # the vocab-sharded tier holds the bare parameter tree
                state = spmd.shard_state(
                    TrainState.create(jax.tree.map(jnp.asarray, host0), tx), mesh, cfg
                )
                new, loss = steps[program](state, spmd.shard_batch(batch_d, mesh, cfg), rng)
                new = new.params
            else:
                new, loss = steps[program](TrainState.create(params, tx), batch_d, rng)
                new = new.params["params"]
        updates = jax.tree.map(lambda a, p: np.asarray(a, np.float64) - p,
                               jax.device_get(new), host0)
        return float(loss), updates

    return run


def phase_spmd_vs_single(seeds=SPMD_SEEDS, n_items: int = N_ITEMS, batch: int = BATCH) -> None:
    """The vocab-sharded step on a (data=1, model=4) mesh against the
    one-card step, same batch, parameters and seed, on each of ``seeds``,
    each dtype against its noise witness (module constants above)."""
    run = spmd_steps(n_items, batch)
    recs = []
    for seed in seeds:
        l1f, u1f = run(seed, "float32", "single")
        _, urf = run(seed, "float32", "remat")
        l4f, u4f = run(seed, "float32", "sharded")
        l1b, u1b = run(seed, "bfloat16", "single")
        l4b, u4b = run(seed, "bfloat16", "sharded")
        f32_upd, f32_leaf = _worst_leaf(u4f, u1f)
        bf16_upd, bf16_leaf = _worst_leaf(u4b, u1f)
        rec = {
            "phase": "spmd_vs_single", "seed": seed, "mesh": [1, 4],
            "float32": {"loss": l4f, "loss_rel_err": abs(l4f - l1f) / abs(l1f),
                        "sharded_vs_one_card": f32_upd, "worst_leaf": f32_leaf,
                        "witness_remat_vs_one_card": _worst_leaf(urf, u1f)[0]},
            "bfloat16": {"loss": l4b, "loss_rel_err": abs(l4b - l1b) / abs(l1b),
                         "sharded_vs_f32": bf16_upd, "worst_leaf": bf16_leaf,
                         "witness_one_card_vs_f32": _worst_leaf(u1b, u1f)[0],
                         "sharded_vs_one_card": _worst_leaf(u4b, u1b)[0]},
        }
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    f32_bound = SPMD_FACTOR * max(
        [SPMD_F32_FLOOR] + [r["float32"]["witness_remat_vs_one_card"] for r in recs]
    )
    bf16_bound = SPMD_FACTOR * max(r["bfloat16"]["witness_one_card_vs_f32"] for r in recs)
    print(json.dumps({
        "phase": "spmd_vs_single", "tolerance": {
            "f32_loss": SPMD_F32_LOSS_TOL, "f32_updates": f32_bound,
            "bf16_loss": SPMD_BF16_LOSS_TOL, "bf16_updates_vs_f32": bf16_bound}}), flush=True)
    for r in recs:
        f32, bf16, seed = r["float32"], r["bfloat16"], r["seed"]
        _check(f32["loss_rel_err"] <= SPMD_F32_LOSS_TOL,
               f"seed {seed}: f32 spmd loss differs by {f32['loss_rel_err']}")
        _check(f32["sharded_vs_one_card"] <= f32_bound,
               f"seed {seed}: f32 spmd update of {f32['worst_leaf']} differs by "
               f"{f32['sharded_vs_one_card']}; the bound is {f32_bound}")
        _check(bf16["loss_rel_err"] <= SPMD_BF16_LOSS_TOL,
               f"seed {seed}: bf16 spmd loss differs by {bf16['loss_rel_err']}")
        _check(bf16["sharded_vs_f32"] <= bf16_bound,
               f"seed {seed}: bf16 sharded updates are {bf16['sharded_vs_f32']} from "
               f"float32 ({bf16['worst_leaf']}); the bound is {bf16_bound}")


def phases(four: bool) -> list[str]:
    return ["device", "dp_vs_single", "spmd_vs_single"] if four else [
        "device", "ce", "attention", "train", "serve"
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card data-parallel and vocab-sharded checks")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    n = 4 if args.four else 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        for name in phases(args.four):
            print(f"== {name}", flush=True)
            if name == "device":
                phase_device(n)
            elif name == "ce":
                phase_ce()
            elif name == "attention":
                phase_attention()
            elif name == "train":
                phase_train(os.path.join(root, "flagship"))
            elif name == "serve":
                phase_serve(os.path.join(root, "flagship"))
            elif name == "dp_vs_single":
                phase_dp_vs_single(root)
            elif name == "spmd_vs_single":
                phase_spmd_vs_single()
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

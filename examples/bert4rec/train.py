"""BERT4Rec-on-Amazon-Beauty training driver.

Counterpart of the reference's example app
(examples/BERT4Rec/source/main.py): leave-one-out Cloze training over
beauty.txt with recall@k / NDCG@k eval against the full catalog.

Two model presets:
* ``--preset parity`` — the reference configuration (source/main.py:186-263):
  2 layers, 2 heads, d_model 64, ffn 100, dropout 0.1, MLP softmax head
  [1024,512,256,128], Adam 1e-3, sinusoidal positions.
* ``--preset flagship`` — the flagship: 4L/256d bf16, learned positions,
  tied-weight softmax head (BASELINE.json configs[1]).

Usage:
  python examples/bert4rec/train.py --data /root/reference/examples/BERT4Rec/raw_data/beauty.txt \
      --model_dir /tmp/run1 --preset parity --epochs 200
  python examples/bert4rec/train.py --simulated --n_items 1000 ...
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
# dropout bits from the backend's rng_bit_generator rather than threefry
# hashing in the step
jax.config.update("jax_default_prng_impl", "rbg")
import jax.numpy as jnp
from bert4clickpath.utils.compile_cache import enable as _enable_compile_cache

_enable_compile_cache()

import numpy as np

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.data.beauty import load_beauty
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.trainer import Trainer


def build_model_config(preset: str, vocab, args) -> ModelConfig:
    if preset == "parity":
        # reference defaults (source/main.py:186-263) unless overridden —
        # --parity_scale lifts the encoder to the --d_model/--layers/--heads
        # shape while keeping the reference MLP softmax head (whose untied
        # 128-wide output layer + per-item bias out-ranks tied heads on
        # sparse catalogs; BASELINE.md quality ledger)
        scaled = args.parity_scale
        d = args.d_model if scaled else 64
        return ModelConfig(
            features={"items": FeatureConfig(vocab.model_vocab_size, d)},
            num_layers=args.layers if scaled else 2,
            num_heads=args.heads if scaled else 2,
            ffn_dim=4 * d if scaled else 100,
            dropout_rate=args.dropout,
            max_len=args.max_items + 3,
            positional="sinusoidal",
            head=HeadConfig(
                "softmax",
                tuple(int(x) for x in args.head_dims.split(",") if x)
                or (1024, 512, 256, 128),
                vocab.label_vocab_size,
            ),
            dtype=args.dtype or ("bfloat16" if scaled else "float32"),
            qkv_fused=args.qkv_fused,
            norm_style=args.norm_style,
        )
    if preset == "flagship":
        from bert4clickpath.parallel.spmd import padded_vocab_rows

        embed_dim = args.embed_dim or args.d_model
        return ModelConfig(
            # rows padded so the fused CE's tiles and the eval scan's
            # chunks divide the table
            features={
                "items": FeatureConfig(
                    padded_vocab_rows(vocab.model_vocab_size, 1), embed_dim
                )
            },
            # factorized input when table dim < encoder width (ALBERT-style)
            encoder_dim=args.d_model if embed_dim != args.d_model else 0,
            num_layers=args.layers,
            num_heads=args.heads,
            ffn_dim=4 * args.d_model,
            dropout_rate=args.dropout,
            max_len=args.max_items + 3,
            positional="learned",
            # output_size pins V so padded rows never enter dense logits
            head=HeadConfig(
                "tied_softmax",
                dense_dims=tuple(
                    int(x) for x in args.head_dims.split(",") if x
                ),
                output_size=vocab.label_vocab_size,
                tied_bias=args.tied_bias,
            ),
            dtype=args.dtype or "bfloat16",
            qkv_fused=args.qkv_fused,
            norm_style=args.norm_style,
        )
    raise ValueError(preset)


def to_device(batch):
    return {
        "features": {k: jnp.asarray(v) for k, v in batch.features.items()},
        "head_positions": jnp.asarray(batch.head_positions),
        "labels": jnp.asarray(batch.labels),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="/root/reference/examples/BERT4Rec/raw_data/beauty.txt")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--preset", choices=["parity", "flagship"], default="parity")
    p.add_argument(
        "--dtype", default="", choices=["", "float32", "bfloat16"],
        help="override the preset's activation dtype",
    )
    p.add_argument(
        "--parity_scale", action="store_true",
        help="parity preset: scale the encoder to --d_model/--layers/--heads "
        "(bf16) while keeping the reference MLP softmax head",
    )
    p.add_argument("--simulated", action="store_true")
    p.add_argument("--n_items", type=int, default=1000)
    p.add_argument("--n_sessions", type=int, default=20000)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument(
        "--mask_pct", type=float, default=0.0,
        help="Cloze mask rate (0 = reference default 0.4; Sun et al. 2019 "
        "report 0.6 as the Beauty optimum)",
    )
    p.add_argument(
        "--max_masked", type=int, default=10,
        help="mask-slot cap P (reference cloze_constants.py:1)",
    )
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = one full pass")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument(
        "--embed_dim", type=int, default=0,
        help="flagship preset: item-table dim (0 = d_model); when smaller, a "
        "factorized input projection feeds the d_model-wide encoder",
    )
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument(
        "--head_dims", default="",
        help="comma dims for the head MLP: the tied-head transform (flagship "
        "preset, BERT-MLM style) or the parity softmax head's dense stack "
        "(default 1024,512,256,128 — the reference's source/main.py:262)",
    )
    p.add_argument(
        "--norm_style", default="post", choices=["post", "pre"],
        help="residual/LayerNorm order: post = reference blocks "
        "(transformer.py:202-213); pre = pre-LN (+ final LN) — the depth-"
        "stability variant (post-LN 6L collapses on Beauty, BASELINE.md)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--sampled_softmax", type=int, default=0,
        help="train on N batch-shared uniform negatives instead of the "
        "full catalog (O(N*S*D) loss; eval stays exact) — the very-large-"
        "catalog escape hatch; single-device path only",
    )
    p.add_argument(
        "--qkv_fused",
        action="store_true",
        help="single (D, 3D) QKV projection (one matmul instead of three; "
        "the tensor-parallel tier (parallel/tp.py) rejects it)",
    )
    p.add_argument("--eval_batches", type=int, default=0, help="0 = full eval")
    p.add_argument("--eval_batch", type=int, default=0, help="0 = --batch")
    p.add_argument(
        "--eval_every", type=int, default=1,
        help="run the full-catalog eval every N epochs (patience counters "
        "advance only on evaluated epochs)",
    )
    p.add_argument(
        "--parallel", default="auto", choices=["auto", "none", "dp"],
        help="auto: data-parallel over all local devices when >1 (the "
        "reference MirroredStrategy behavior); dp: force; none: one device",
    )
    p.add_argument(
        "--steps_per_call", type=int, default=-1,
        help="train steps per device dispatch (lax.scan). -1 auto: a whole "
        "epoch on an accelerator (one dispatch and one host-to-device "
        "transfer per epoch, so the host's per-step cost is paid once), 1 "
        "on the CPU; works on the single-device and DP paths",
    )
    p.add_argument(
        "--mu_dtype", default="float32", choices=["float32", "bfloat16"],
        help="Adam first-moment dtype; bfloat16 halves its HBM traffic",
    )
    p.add_argument(
        "--ema_decay", type=float, default=0.0,
        help="EMA of params for eval/export (e.g. 0.999; 0 disables). "
        "Resume requires the checkpoint to carry the same EMA setting.",
    )
    p.add_argument(
        "--tied_bias", action="store_true",
        help="flagship preset: free per-item output bias on the tied head "
        "(BERT MLM-decoder style)",
    )
    p.add_argument(
        "--fused_head", action="store_true",
        help="parity/MLP softmax head: train+eval through the fused "
        "CE / chunked catalog scan (no dense (B,P,V) logits); numerically "
        "equivalent, several times faster at full-catalog scale",
    )
    p.add_argument("--init_ckpt", default=None, help="warm-start params path")
    p.add_argument(
        "--resume", action="store_true",
        help="resume full state from the latest checkpoint in model_dir/ckpts",
    )
    # Default to the ranking metric: BASELINE.md documents that val_loss
    # monitoring early-stops this task at ~0.02 recall@10 while NDCG is
    # still improving (the reference's val_loss monitor was a latent trap).
    p.add_argument("--monitor", default="val_ndcg@10")
    # "auto" resolves from the metric name (loss -> min, else max), so
    # `--monitor val_loss` alone can't silently maximize a loss
    p.add_argument(
        "--monitor_mode", default="auto", choices=["auto", "min", "max"]
    )
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--plateau_patience", type=int, default=10)
    p.add_argument(
        "--eval_steps_per_call", type=int, default=1,
        help="eval batches per device dispatch (scanned eval, single-device "
        "path only). evaluate() fetches once per pass, so per-batch "
        "dispatches already pipeline; this is for many-tiny-batch eval sets "
        "where dispatch count dominates",
    )
    p.add_argument(
        "--ckpt_keep", type=int, default=0,
        help="retain at most N best-so-far checkpoints (0 = keep all, the "
        "reference's timestamped-ModelCheckpoint accumulation — ~10 GB per "
        "Beauty run)",
    )
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument(
        "--wd_tables", action="store_true",
        help="extend --weight_decay to embedding tables / learned positions "
        "(the tied head's output layer; the main memorization surface on "
        "small corpora)",
    )
    p.add_argument(
        "--schedule", default="constant",
        choices=["constant", "rsqrt_warmup", "warmup_constant"],
    )
    p.add_argument("--warmup_steps", type=int, default=4000)
    args = p.parse_args(argv)

    if args.simulated:
        gen = ClickStreamGenerator(
            n_items=args.n_items, session_cohesiveness=200, seed=args.seed
        )
        sequences, _ = gen.generate_sessions(args.n_sessions)
        vocab = gen.item_vocab()
    elif os.path.isdir(args.data):
        # prepared directory from examples/bert4rec/prepare_data.py
        # (packed npz shards + vocab) — the reference's prep-once/train-many
        # workflow (data_prep/main.py writes, source/main.py reads)
        from bert4clickpath.data import etl
        from bert4clickpath.vocab import Vocabulary

        vocab = Vocabulary.from_file(
            os.path.join(args.data, "vocabs", "item_vocab.txt")
        )
        sequences = etl.read_packed(os.path.join(args.data, "sequences_*.npz"))
        if not sequences:
            raise SystemExit(f"no sequences_*.npz shards under {args.data}")
        # prepare_data already truncated to its --max_seq_len; re-truncation
        # here would silently change the corpus
        too_long = max(len(s) for s in sequences)
        if too_long > args.max_items:
            raise SystemExit(
                f"prepared sequences up to {too_long} items exceed "
                f"--max_items {args.max_items}; re-run prepare_data or raise "
                "the flag"
            )
    else:
        sequences, vocab = load_beauty(args.data, max_seq_len=args.max_items)
    print(f"sequences={len(sequences)} items={vocab.size}", flush=True)

    ds = ClozeDataset(
        sequences,
        vocab,
        max_items=args.max_items,
        max_masked=args.max_masked,
        masked_percentage=args.mask_pct or None,
    )
    cfg = build_model_config(args.preset, vocab, args)
    steps_per_epoch = args.steps_per_epoch or max(1, len(ds) // args.batch)
    tcfg = TrainConfig(
        batch_size=args.batch,
        learning_rate=args.lr,
        n_epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        validation_steps=args.eval_batches,
        seed=args.seed,
        monitor=args.monitor,
        monitor_mode=args.monitor_mode,
        early_stopping_patience=args.patience,
        plateau_patience=args.plateau_patience,
        eval_every=args.eval_every,
        eval_batch_size=args.eval_batch,
        ckpt_keep=args.ckpt_keep,
    )

    model = ClickstreamModel(cfg)
    b0 = to_device(next(ds.train_batches(args.batch, seed=args.seed)))
    params = model.init(
        {"params": jax.random.PRNGKey(args.seed)}, b0["features"], b0["head_positions"]
    )
    if args.init_ckpt:
        params = ckpt_lib.restore_encoder(args.init_ckpt, jax.device_get(params))
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"model={args.preset} d_model={cfg.d_model} params={n_params:,}", flush=True)

    tx = make_optimizer(
        tcfg,
        mu_dtype=jnp.dtype(args.mu_dtype),
        weight_decay=args.weight_decay,
        decay_tables=args.wd_tables,
    )
    state = TrainState.create(params, tx, ema=args.ema_decay > 0)
    if args.resume:
        latest = ckpt_lib.latest_checkpoint(os.path.join(args.model_dir, "ckpts"))
        if latest:
            state = ckpt_lib.restore_state(latest, jax.device_get(state))
            print(f"resumed from {latest} at step {int(state.step)}", flush=True)
    if args.schedule == "rsqrt_warmup":
        # Vaswani schedule scaled so the post-warmup peak equals --lr
        peak = (cfg.d_model * args.warmup_steps) ** -0.5
        schedule = schedules.rsqrt_warmup(
            cfg.d_model, args.warmup_steps, scale=tcfg.learning_rate / peak
        )
    elif args.schedule == "warmup_constant":
        schedule = schedules.warmup_constant(tcfg.learning_rate, args.warmup_steps)
    else:
        schedule = schedules.constant(tcfg.learning_rate)
    # tied heads train through the fused CE (no dense logits);
    # --fused_head opts the parity MLP head into the same kernel
    fused_num_valid = (
        vocab.label_vocab_size
        if cfg.head.kind == "tied_softmax"
        or (cfg.head.kind == "softmax" and args.fused_head)
        else None
    )
    n_dev = len(jax.devices())
    use_dp = args.parallel == "dp" or (args.parallel == "auto" and n_dev > 1)
    # validate the (tier × head × sampled) combination up front
    # against the shared support matrix (parallel/support.py) — fail before
    # any step is built, not on first dispatch
    from bert4clickpath.parallel.support import validate_tier

    try:
        validate_tier(
            "dp" if use_dp else "single",
            cfg.head.kind,
            qkv_fused=cfg.qkv_fused,
            sampled=args.sampled_softmax,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    if args.sampled_softmax and not fused_num_valid:
        raise SystemExit(
            "--sampled_softmax requires a softmax-family head (tied preset "
            "or --fused_head)"
        )
    sampled_kw = (
        {"sampled_softmax_samples": args.sampled_softmax}
        if args.sampled_softmax
        else {}
    )
    batch_to_device = to_device
    # scan multi-step resolution, shared by both paths
    spc, stack_batches = args.steps_per_call, None
    if spc < 0:  # auto: amortize the host's per-dispatch cost
        spc = steps_per_epoch if jax.default_backend() != "cpu" else 1
    elif spc > 1 and steps_per_epoch % spc:
        # an explicit request that can't be honored is an error, not a
        # silent fallback to per-step dispatch
        raise SystemExit(
            f"--steps_per_call {spc} does not divide steps_per_epoch "
            f"{steps_per_epoch}"
        )
    espc = max(1, args.eval_steps_per_call)
    if use_dp:
        espc = 1  # DP eval shards per-batch; scanned eval is single-chip
    if spc > 1 or espc > 1:
        from bert4clickpath.data.cloze import stack_batches as _stack

        stack_batches = _stack
    if use_dp:
        # all local devices, data-parallel — the reference trained its only
        # model under MirroredStrategy whenever >1 GPU was present
        # (source/main.py:46-57,262); this is that behavior on a device mesh
        from bert4clickpath import MeshConfig
        from bert4clickpath.parallel import spmd
        from bert4clickpath.parallel.mesh import make_mesh

        eval_bs_check = args.eval_batch or args.batch
        if args.batch % n_dev or eval_bs_check % n_dev:
            raise SystemExit(
                f"--parallel dp: batch {args.batch} and eval batch "
                f"{eval_bs_check} must divide over {n_dev} devices"
            )
        mesh = make_mesh(MeshConfig(data=n_dev, model=1))
        state = spmd.replicate_state(state, mesh)
        if spc > 1:
            print(f"DP scan train step: {spc} steps/dispatch", flush=True)
        train_step = spmd.make_dp_train_step(
            model, mesh, tx, schedule,
            ema_decay=args.ema_decay,
            fused_ce_num_valid=fused_num_valid,
            steps_per_call=spc,
        )
        eval_step = spmd.make_dp_eval_step(
            model, mesh, ks=(5, 10), chunked_num_valid=fused_num_valid
        )

        def batch_to_device(b):
            d = to_device(b)
            if d["labels"].ndim == 3:  # (K, B, P) stacked train chunk
                return spmd.shard_stacked_batch(d, mesh, cfg)
            return spmd.shard_batch(d, mesh, cfg)

        print(f"data-parallel over {n_dev} devices", flush=True)
    else:
        if spc > 1:
            from bert4clickpath.training.train_state import (
                make_scan_train_step,
            )

            train_step = make_scan_train_step(
                model,
                tx,
                schedule,
                fused_ce_num_valid=fused_num_valid,
                ema_decay=args.ema_decay,
                **sampled_kw,
            )
            print(f"scan train step: {spc} steps/dispatch", flush=True)
        else:
            train_step = make_train_step(
                model,
                tx,
                schedule,
                fused_ce_num_valid=fused_num_valid,
                ema_decay=args.ema_decay,
                **sampled_kw,
            )
        eval_step = make_eval_step(
            model,
            ks=(5, 10),
            # tied heads (and --fused_head MLP heads) evaluate via the
            # chunked blinded catalog scan
            chunked_num_valid=fused_num_valid,
            steps_per_call=espc,
        )
        if espc > 1:
            print(f"scan eval step: {espc} batches/dispatch", flush=True)

    def export_fn(best_params):
        ckpt_lib.export_serving(
            os.path.join(args.model_dir, "export"), best_params, cfg, {"items": vocab}
        )

    trainer = Trainer(
        train_step,
        eval_step,
        tcfg,
        model_dir=args.model_dir,
        to_device=batch_to_device,
        export_fn=export_fn,
        lr_fn=schedule,
        steps_per_call=spc,
        stack_batches=stack_batches,
        eval_steps_per_call=espc,
    )
    eval_limit = args.eval_batches or None
    eval_bs = args.eval_batch or args.batch
    state = trainer.fit(
        state,
        ds.train_batches(args.batch, seed=args.seed + 1),
        lambda: ds.eval_batches(eval_bs, limit_batches=eval_limit),
        jax.random.PRNGKey(args.seed + 2),
    )
    print("done", flush=True)


if __name__ == "__main__":
    main()

"""Transfer-learning chain: Cloze pretrain -> binary purchase-intent head.

BASELINE.json configs[3]: pretrain the Cloze recommender (tied softmax),
then load the encoder + item embeddings under a fresh binary head routed to
the [CLS] summary token (reference's fine-tune path: source/main.py:100-120
warm start + segment_to_head=0 CLS routing, clickstream_transformer.py:317-322).

Synthetic task: sessions whose item-id running mean is high "intend to
purchase" — learnable only through the item embeddings, so transfer from
pretraining should beat training the head from scratch.

  python examples/bert4rec/transfer.py --model_dir /tmp/tl
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_default_prng_impl", "rbg")
import jax.numpy as jnp
import numpy as np

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.constants import LABEL_PAD
from bert4clickpath.data.cloze import make_eval_batch, make_train_batch
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.ops import metrics as M
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)


def _to_device(batch):
    return {
        "features": {k: jnp.asarray(v) for k, v in batch.features.items()},
        "head_positions": jnp.asarray(batch.head_positions),
        "labels": jnp.asarray(batch.labels),
    }


def binary_batches(
    sequences, n_items, batch, max_items, rng, shuffle=True, threshold_frac=0.5
):
    """CLS-routed binary batches: label = 1 iff mean item id > the
    ``threshold_frac`` point of the id range (0.5 = balanced; higher makes
    positives rare, the reference's pos_weight use case, losses.py:71-96)."""
    from bert4clickpath.data.cloze import _empty_batch

    n = len(sequences)
    order = rng.permutation(n) if shuffle else np.arange(n)
    threshold = (n_items - 1) * threshold_frac
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        tokens, _, _ = _empty_batch(batch, max_items, 1)
        labels = np.full((batch, 1), LABEL_PAD, np.int32)
        from bert4clickpath.constants import NUM_RESERVED_TOKENS

        for bi, si in enumerate(idx):
            seq = sequences[si][:max_items]
            tokens[bi, 2 : 2 + len(seq)] = seq + NUM_RESERVED_TOKENS
            labels[bi, 0] = int(seq.mean() > threshold)
        yield {
            "features": {"items": jnp.asarray(tokens)},
            "head_positions": None,
            "labels": jnp.asarray(labels),
        }


def finetune(model, params, tcfg, batches_fn, steps, lr, rng_key, loss_fn=None):
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    step = make_train_step(
        model, tx, schedules.constant(lr), loss_fn=loss_fn, donate=False
    )
    it = batches_fn()
    for i in range(steps):
        try:
            b = next(it)
        except StopIteration:
            it = batches_fn()
            b = next(it)
        state, loss = step(state, b, rng_key)
    return state, float(np.asarray(loss))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--n_items", type=int, default=200)
    p.add_argument("--n_sessions", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--pretrain_steps", type=int, default=300)
    p.add_argument("--finetune_steps", type=int, default=60)
    p.add_argument("--max_items", type=int, default=30)
    p.add_argument(
        "--pos_frac", type=float, default=0.5,
        help="id-range threshold fraction for the intent label; >0.5 makes "
        "positives rare and activates pos_weight (reference losses.py:71-96)",
    )
    p.add_argument(
        "--pos_weight", type=float, default=0.0,
        help="positive-class loss weight; 0 = auto (neg/pos ratio measured "
        "on the corpus) when --pos_frac != 0.5, else unweighted",
    )
    args = p.parse_args(argv)

    gen = ClickStreamGenerator(
        n_items=args.n_items, session_cohesiveness=200, seed=0
    )
    sequences, _ = gen.generate_sessions(args.n_sessions)
    vocab = gen.item_vocab()
    ds = ClozeDataset(sequences, vocab, max_items=args.max_items)

    # ---- stage 1: Cloze pretrain (tied softmax) -------------------------
    pre_cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=args.max_items + 3,
        head=HeadConfig("tied_softmax"),
    )
    pre_model = ClickstreamModel(pre_cfg)
    tcfg = TrainConfig(batch_size=args.batch)
    b0 = _to_device(next(ds.train_batches(args.batch, seed=0)))
    params = pre_model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    step = make_train_step(pre_model, tx, schedules.constant(2e-3), donate=False)
    it = ds.train_batches(args.batch, seed=1)
    for i in range(args.pretrain_steps):
        state, loss = step(state, _to_device(next(it)), jax.random.PRNGKey(2))
    print(f"pretrain final loss {float(np.asarray(loss)):.4f}", flush=True)
    pre_dir = os.path.join(args.model_dir, "pretrained")
    ckpt_lib.save_params(
        pre_dir, ckpt_lib.init_params_like_subset(jax.device_get(state.params))
    )

    # ---- stage 2: binary purchase-intent head on [CLS] ------------------
    ft_cfg = ModelConfig(
        features=pre_cfg.features,
        num_layers=pre_cfg.num_layers,
        num_heads=pre_cfg.num_heads,
        ffn_dim=pre_cfg.ffn_dim,
        max_len=pre_cfg.max_len,
        head=HeadConfig("binary", (32,)),
        routing="segment",
        segment_bounds=(0, 1),  # the CLS summary token
    )
    ft_model = ClickstreamModel(ft_cfg)
    rngb = np.random.default_rng(3)
    fb0 = next(binary_batches(
        sequences, args.n_items, args.batch, args.max_items, rngb,
        threshold_frac=args.pos_frac,
    ))
    fresh = ft_model.init({"params": jax.random.PRNGKey(4)}, fb0["features"])

    # imbalance-aware loss: weight rare positives by the measured neg/pos
    # ratio (reference's pos_weight for return/purchase tasks,
    # source/main.py:63-76; losses.py:71-96)
    loss_fn = None
    pos_weight = args.pos_weight
    if not pos_weight and args.pos_frac != 0.5:
        thr = (args.n_items - 1) * args.pos_frac
        pos = sum(float(s[: args.max_items].mean() > thr) for s in sequences)
        pos_rate = pos / len(sequences)
        pos_weight = (1.0 - pos_rate) / max(pos_rate, 1e-6)
    if pos_weight:
        from functools import partial

        from bert4clickpath.ops.losses import masked_binary_cross_entropy

        loss_fn = partial(masked_binary_cross_entropy, pos_weight=pos_weight)
        print(f"pos_weight={pos_weight:.2f}", flush=True)

    def stream():
        return binary_batches(
            sequences, args.n_items, args.batch, args.max_items,
            np.random.default_rng(5), threshold_frac=args.pos_frac,
        )

    results = {}
    for name, init_params in (
        ("scratch", jax.device_get(fresh)),
        ("transfer", ckpt_lib.restore_encoder(pre_dir, jax.device_get(fresh))),
    ):
        st, final_loss = finetune(
            ft_model, init_params, tcfg, stream, args.finetune_steps, 1e-3,
            jax.random.PRNGKey(6), loss_fn=loss_fn,
        )
        ev = make_eval_step(ft_model, loss_fn=loss_fn)
        acc = None
        for b in binary_batches(
            sequences, args.n_items, args.batch, args.max_items,
            np.random.default_rng(7), shuffle=False,
            threshold_frac=args.pos_frac,
        ):
            s = {k: np.asarray(v) for k, v in ev(st.params, b).items()}
            acc = s if acc is None else M.merge(acc, s)
        out = M.finalize(acc)
        results[name] = out
        print(
            f"{name}: loss {final_loss:.4f} f1 {out['f1']:.4f} "
            f"pred_pos {out['pred_positives']:.3f}",
            flush=True,
        )
    if results["transfer"]["f1"] > results["scratch"]["f1"]:
        print("TRANSFER WINS", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()

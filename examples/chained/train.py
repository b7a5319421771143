"""Multi-sequence chaining end-to-end: history + basket -> return prediction.

Exercises the reference's TransformerInputPrep composition
(clickstream_transformer.py:38-94,317-322) that no other example drives:
TWO chained sequences (``[CLS][SEP] history [SEP] basket [SEP]``),
``routing='segment'`` mounting the head on segment 2 (the basket), and
segment embeddings distinguishing the spans — plus the binary head with
``pos_weight`` (the reference's commented return/purchase tasks,
source/main.py:63-76; losses.py:71-96).

Synthetic task (learnable only through cross-segment attention): a basket
item is RETURNED (label 1) iff it never appeared in the user's history,
with 10% label noise. A model that cannot see across segments can only
predict the base rate; cross-attention pushes masked accuracy toward 90%.

The membership rule takes ~15 epochs to emerge (the model must learn an
attention-based "is this basket item in the history" check); by epoch 40
masked F1 reaches ~0.85 vs the 0.64 all-positive baseline (0.90 = noise
ceiling). Runs on the CPU or a GPU:
  python examples/chained/train.py --model_dir /tmp/chained
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
from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS, PAD_ID
from bert4clickpath.data.chaining import (
    chain_sequences,
    chained_length,
    segment_bounds,
)
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.ops.losses import masked_binary_cross_entropy
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.trainer import Trainer

BASKET_LEN = 8


def make_chained_batches(
    histories, batch, max_hist, rng, *, noise=0.1, return_rate=0.5, train=True,
    n_catalog=10_000,
):
    """(B, chained_length) tokens + (B, BASKET_LEN) binary labels.

    Basket items are drawn half from the history (label 0: kept) and half
    from the rest of the catalog (label 1: returned), ``noise`` flipped.
    """
    n = len(histories)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        hist = np.full((batch, max_hist), PAD_ID, np.int32)
        basket = np.full((batch, BASKET_LEN), PAD_ID, np.int32)
        labels = np.full((batch, BASKET_LEN), LABEL_PAD, np.int32)
        for bi, si in enumerate(idx):
            h = np.asarray(histories[si], np.int32)[-max_hist:]
            hist[bi, : len(h)] = h + NUM_RESERVED_TOKENS
            k = int(rng.integers(BASKET_LEN // 2, BASKET_LEN + 1))
            hset = set(int(x) for x in h)
            for j in range(k):
                if rng.random() < 1.0 - return_rate and hset:
                    item = int(rng.choice(sorted(hset)))
                else:
                    item = int(rng.integers(0, n_catalog))
                returned = 0 if item in hset else 1
                if rng.random() < noise:
                    returned = 1 - returned
                basket[bi, j] = item + NUM_RESERVED_TOKENS
                labels[bi, j] = returned
        tokens = chain_sequences([hist, basket])
        yield {
            "features": {"items": jnp.asarray(tokens)},
            "head_positions": jnp.zeros((batch, 1), jnp.int32),  # unused: segment routing
            "labels": jnp.asarray(labels),
        }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--n_items", type=int, default=300)
    p.add_argument("--n_sessions", type=int, default=4000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--max_hist", type=int, default=24)
    p.add_argument(
        "--pos_weight", type=float, default=2.0,
        help="returned-class weight (reference MaskedLoss pos_weight)",
    )
    args = p.parse_args(argv)

    gen = ClickStreamGenerator(
        n_items=args.n_items, session_cohesiveness=200, seed=0
    )
    histories, _ = gen.generate_sessions(args.n_sessions)
    vocab = gen.item_vocab()

    seg_lens = (args.max_hist, BASKET_LEN)
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=chained_length(seg_lens),
        routing="segment",
        # head mounts on segment 2 = the basket span
        segment_bounds=segment_bounds(seg_lens, 2),
        use_segment_embeddings=True,
        head=HeadConfig("binary", (64, 32)),
    )
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg)
    rng = np.random.default_rng(0)
    b0 = next(make_chained_batches(histories, args.batch, args.max_hist, rng, n_catalog=args.n_items))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)

    def loss_fn(logits, labels, axis_name=None):
        return masked_binary_cross_entropy(
            logits, labels, pos_weight=args.pos_weight, axis_name=axis_name
        )

    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), loss_fn=loss_fn),
        make_eval_step(model, loss_fn=loss_fn),
        tcfg,
        model_dir=args.model_dir,
    )

    def train_stream():
        r = np.random.default_rng(1)
        while True:
            yield from make_chained_batches(
                histories, args.batch, args.max_hist, r, n_catalog=args.n_items
            )

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_chained_batches(
            histories, args.batch, args.max_hist, np.random.default_rng(2),
            train=False, n_catalog=args.n_items,
        ),
        jax.random.PRNGKey(2),
    )
    # headline: masked accuracy via the streaming binary counts
    last = trainer.history[-1]
    print(
        "final:",
        {k: round(v, 4) for k, v in last.items() if isinstance(v, float)},
        flush=True,
    )
    print("done", flush=True)


if __name__ == "__main__":
    main()

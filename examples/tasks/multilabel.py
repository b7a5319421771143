"""Multi-label multi-class driver: session -> classes of the held-out tail.

Makes the reference's third head reachable end-to-end
(MultiLabel_MultiClass_classification, head.py:50-69 — wired nowhere in
the reference either): the [CLS] summary (``segment_to_head`` routing on
segment 0, clickstream_transformer.py:317-322) feeds a C-way
independent-sigmoid head trained with the masked multilabel BCE.

Synthetic task: items belong to ``n_classes`` interest classes
(item mod C); the model sees the session WITHOUT its last ``held_out``
items and predicts the multi-hot set of classes those hidden items touch.
Session cohesion makes this predictable well above the base rate.

  python examples/tasks/multilabel.py --model_dir /tmp/ml --epochs 10
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
from bert4clickpath.constants import NUM_RESERVED_TOKENS, PAD_ID
from bert4clickpath.data.chaining import chain_sequences, chained_length
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.trainer import Trainer


def make_batches(
    sessions, batch, max_items, n_classes, rng, *, held_out=3, train=True
):
    n = len(sessions)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        hist = np.full((batch, max_items), PAD_ID, np.int32)
        labels = np.zeros((batch, n_classes), np.int32)
        for bi, si in enumerate(idx):
            s = np.asarray(sessions[si], np.int32)
            if len(s) <= held_out:
                continue
            visible, hidden = s[:-held_out][-max_items:], s[-held_out:]
            hist[bi, : len(visible)] = visible + NUM_RESERVED_TOKENS
            labels[bi, np.unique(hidden % n_classes)] = 1
        tokens = chain_sequences([hist])
        yield {
            "features": {"items": jnp.asarray(tokens)},
            "head_positions": jnp.zeros((batch, 1), jnp.int32),  # unused
            "labels": jnp.asarray(labels),
        }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--n_items", type=int, default=500)
    p.add_argument("--n_classes", type=int, default=12)
    p.add_argument("--n_sessions", type=int, default=3000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--max_items", type=int, default=24)
    args = p.parse_args(argv)

    gen = ClickStreamGenerator(
        n_items=args.n_items, session_cohesiveness=200, seed=0
    )
    sessions, _ = gen.generate_sessions(args.n_sessions)
    vocab = gen.item_vocab()

    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=chained_length((args.max_items,)),
        routing="segment",
        segment_bounds=(0, 1),  # [CLS] summary slot (reference :317-322)
        head=HeadConfig("multilabel", (64,), args.n_classes),
    )
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg)
    rng = np.random.default_rng(0)
    b0 = next(
        make_batches(sessions, args.batch, args.max_items, args.n_classes, rng)
    )
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3)),
        make_eval_step(model),
        tcfg,
        model_dir=args.model_dir,
    )

    def train_stream():
        r = np.random.default_rng(1)
        while True:
            yield from make_batches(
                sessions, args.batch, args.max_items, args.n_classes, r
            )

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_batches(
            sessions, args.batch, args.max_items, args.n_classes,
            np.random.default_rng(2), train=False,
        ),
        jax.random.PRNGKey(2),
    )
    last = trainer.history[-1]
    print(
        "final:",
        {k: round(v, 4) for k, v in last.items() if isinstance(v, float)},
        flush=True,
    )
    print("done", flush=True)


if __name__ == "__main__":
    main()

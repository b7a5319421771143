"""Multi-variable clickstream: (action, item) pairs -> next-item retrieval.

BASELINE.json configs[2]: each event is a pair of features embedded
separately and concatenated on the embedding axis (the reference's
multi-variable design, transformer.py:346-390; SURVEY.md §2 "Encoder
stack"), with the next-item retrieval head gathering [MASK] positions.

Runs on the CPU or a GPU with simulated data:
  python examples/bert4rec/multivariable.py --model_dir /tmp/mv --epochs 5
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
from bert4clickpath.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    MASKED_PERCENTAGE,
    MAX_MASKED_ITEMS,
    NA_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath.data.cloze import ITEM_OFFSET, token_length
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.trainer import Trainer


def make_pair_batches(items_seqs, events_seqs, batch, max_items, rng, train=True):
    """Fixed-shape batches with BOTH features masked at the same positions.

    When an item is masked, its event becomes [NA] (the reference's
    missing-event token, constants.py:11) so the model cannot cheat by
    reading the event at a masked slot.
    """
    n = len(items_seqs)
    length = token_length(max_items)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        tokens_i = np.full((batch, length), PAD_ID, np.int32)
        tokens_e = np.full((batch, length), PAD_ID, np.int32)
        for t in (tokens_i, tokens_e):
            t[:, 0] = CLS_ID
            t[:, 1] = SEP_ID
            t[:, -1] = SEP_ID
        positions = np.zeros((batch, MAX_MASKED_ITEMS), np.int32)
        labels = np.full((batch, MAX_MASKED_ITEMS), LABEL_PAD, np.int32)
        for bi, si in enumerate(idx):
            items = items_seqs[si][:-1] if train else items_seqs[si]
            events = events_seqs[si][: len(items)]
            items = items[:max_items]
            events = events[:max_items]
            m = len(items)
            tokens_i[bi, ITEM_OFFSET : ITEM_OFFSET + m] = items + NUM_RESERVED_TOKENS
            tokens_e[bi, ITEM_OFFSET : ITEM_OFFSET + m] = events + NUM_RESERVED_TOKENS
            if train:
                n_masked = int(np.clip(int(m * MASKED_PERCENTAGE), 0, MAX_MASKED_ITEMS))
                picks = np.sort(rng.permutation(m)[:n_masked])
            else:
                n_masked = 1
                picks = np.array([m - 1])
            labels[bi, :n_masked] = items[picks]
            positions[bi, :n_masked] = picks + ITEM_OFFSET
            tokens_i[bi, picks + ITEM_OFFSET] = MASK_ID
            tokens_e[bi, picks + ITEM_OFFSET] = NA_ID
        yield {
            "features": {
                "items": jnp.asarray(tokens_i),
                "events": jnp.asarray(tokens_e),
            },
            "head_positions": jnp.asarray(positions),
            "labels": jnp.asarray(labels),
        }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--n_items", type=int, default=500)
    p.add_argument("--n_events", type=int, default=8)
    p.add_argument("--n_sessions", type=int, default=4000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max_items", type=int, default=30)
    args = p.parse_args(argv)

    gen = ClickStreamGenerator(
        n_items=args.n_items, n_events=args.n_events, session_cohesiveness=200, seed=0
    )
    items, events = gen.generate_sessions(args.n_sessions)
    item_vocab = gen.item_vocab()
    event_vocab = gen.event_vocab()

    cfg = ModelConfig(
        features={
            # (action, item) pair: separate embeddings, concatenated
            "items": FeatureConfig(item_vocab.model_vocab_size, 56),
            "events": FeatureConfig(event_vocab.model_vocab_size, 8),
        },
        num_layers=2,
        num_heads=2,
        ffn_dim=128,
        max_len=args.max_items + 3,
        head=HeadConfig("softmax", (128,), item_vocab.label_vocab_size),
    )
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg)
    rng = np.random.default_rng(0)
    b0 = next(make_pair_batches(items, events, args.batch, args.max_items, rng))
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
            yield from make_pair_batches(items, events, args.batch, args.max_items, r)

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_pair_batches(
            items, events, args.batch, args.max_items, rng, train=False
        ),
        jax.random.PRNGKey(2),
    )

    # export + serve the paired-feature model: dict sessions, [MASK] on the
    # item feature and [NA] on the event feature at the appended next-item
    # slot (training/serving.py multi-variable contract)
    from bert4clickpath.training import checkpoint as ckpt_lib
    from bert4clickpath.training.serving import ServingModel

    export_dir = ckpt_lib.export_serving(
        os.path.join(args.model_dir, "export"),
        jax.device_get(state.params),
        cfg,
        {"items": item_vocab, "events": event_vocab},
    )
    served = ServingModel(export_dir)
    recs = served.recommend(
        [
            {
                "items": [item_vocab.decode_label(i) for i in (0, 1, 2)],
                "events": [event_vocab.decode_label(0)] * 3,
            }
        ],
        k=5,
    )
    print("serving top-5:", [(n, round(s, 3)) for n, s in recs[0]], flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()

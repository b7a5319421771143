"""Multi-sequence chaining end-to-end: segment bounds
pinned against chain_sequences output per the reference arithmetic
(clickstream_transformer.py:81-94,317-322), and the chained
segment-routed binary model trains through the gathered slice."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

# load the example under a unique module name (several examples are all
# called train.py)
_spec = importlib.util.spec_from_file_location(
    "chained_train_example",
    os.path.join(
        os.path.dirname(__file__), "..", "examples", "chained", "train.py"
    ),
)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
BASKET_LEN = _mod.BASKET_LEN
make_chained_batches = _mod.make_chained_batches

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
)
from bert4clickpath.constants import (
    CLS_ID,
    LABEL_PAD,
    NUM_RESERVED_TOKENS,
    SEP_ID,
)
from bert4clickpath.data.chaining import (
    chain_sequences,
    chained_length,
    segment_bounds,
)
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.ops.losses import masked_binary_cross_entropy


def test_segment_bounds_match_chain_sequences():
    """The static bounds must select exactly each chained segment's span —
    the reference's SEP-scan arithmetic, but at compile time."""
    rng = np.random.default_rng(0)
    lens = (5, 3, 4)
    seqs = [rng.integers(10, 50, size=(2, l)).astype(np.int32) for l in lens]
    tokens = chain_sequences(seqs)
    assert tokens.shape == (2, chained_length(lens))
    # layout: [CLS][SEP] s1 [SEP] s2 [SEP] s3 [SEP]
    assert (tokens[:, 0] == CLS_ID).all() and (tokens[:, 1] == SEP_ID).all()
    s0, e0 = segment_bounds(lens, 0)
    assert (s0, e0) == (0, 1)  # CLS summary slot
    start = 2
    for i, l in enumerate(lens, start=1):
        s, e = segment_bounds(lens, i)
        assert (s, e) == (start, start + l)
        np.testing.assert_array_equal(tokens[:, s:e], seqs[i - 1])
        assert (tokens[:, e] == SEP_ID).all()  # trailing SEP excluded
        start += l + 1


def test_chained_batch_layout():
    gen = ClickStreamGenerator(n_items=50, session_cohesiveness=100, seed=0)
    histories, _ = gen.generate_sessions(40)
    b = next(
        make_chained_batches(
            histories, 8, 10, np.random.default_rng(0), n_catalog=50
        )
    )
    tokens = np.asarray(b["features"]["items"])
    labels = np.asarray(b["labels"])
    assert tokens.shape == (8, chained_length((10, BASKET_LEN)))
    s, e = segment_bounds((10, BASKET_LEN), 2)
    basket = tokens[:, s:e]
    # every labeled position holds a real (non-special) basket item
    real = labels != LABEL_PAD
    assert real.any()
    assert (basket[real] >= NUM_RESERVED_TOKENS).all()


def test_chained_model_learns_through_segment_slice():
    """A few dozen steps on one batch must drive the pos_weight binary loss
    far below the base-rate entropy — proving the segment-2 slice, segment
    embeddings, and binary head compose into a trainable path."""
    gen = ClickStreamGenerator(n_items=60, session_cohesiveness=100, seed=0)
    histories, _ = gen.generate_sessions(80)
    vocab = gen.item_vocab()
    b = next(
        make_chained_batches(
            histories, 32, 12, np.random.default_rng(0), n_catalog=60
        )
    )
    seg_lens = (12, BASKET_LEN)
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=chained_length(seg_lens),
        routing="segment",
        segment_bounds=segment_bounds(seg_lens, 2),
        use_segment_embeddings=True,
        dropout_rate=0.0,
        head=HeadConfig("binary", (32,)),
    )
    model = ClickstreamModel(cfg)
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )
    tx = optax.adam(3e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            logits = model.apply(
                p, b["features"], b["head_positions"], deterministic=True
            )
            return masked_binary_cross_entropy(logits, b["labels"], pos_weight=2.0)

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), opt, loss

    first = None
    for _ in range(120):
        params, opt, loss = step(params, opt)
        if first is None:
            first = float(loss)
    assert float(loss) < 0.2 < first

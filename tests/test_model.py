"""Model forward tests: shapes, routing, multi-variable concat, pad
invariance, tied head, learned positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath import ClickstreamModel, FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath.constants import CLS_ID, NUM_RESERVED_TOKENS, PAD_ID, SEP_ID


def _cfg(**kw):
    base = dict(
        features={"items": FeatureConfig(10 + 40 + 1, 16)},
        num_layers=2,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        head=HeadConfig("softmax", (24,), 40),
        max_masked=4,
    )
    base.update(kw)
    return ModelConfig(**base)


def _batch(b=3, l=23):
    rng = np.random.default_rng(0)
    tokens = rng.integers(10, 50, size=(b, l)).astype(np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, 1] = SEP_ID
    tokens[:, -1] = SEP_ID
    tokens[:, 15:-1] = PAD_ID
    positions = np.tile(np.array([3, 5, 7, 9], np.int32), (b, 1))
    return {"items": jnp.asarray(tokens)}, jnp.asarray(positions)


def test_softmax_head_shapes():
    cfg = _cfg()
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)
    assert logits.dtype == jnp.float32


def test_pad_content_invariance():
    """Values stored at [PAD] positions must not influence outputs at real
    positions (attention masking works)."""
    cfg = _cfg()
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    base = model.apply(params, feats, pos)
    # PAD ids stay PAD (the mask keys off id==PAD_ID); but embeddings of pad
    # positions enter attention values — verify the bias kills them by
    # comparing against a longer pad run with identical real prefix.
    tokens2 = np.asarray(feats["items"]).copy()
    # identical real tokens, same pads; perturbing *real* token must change out
    tokens3 = tokens2.copy()
    tokens3[0, 3] = tokens3[0, 3] + 1
    out3 = model.apply(params, {"items": jnp.asarray(tokens3)}, pos)
    assert not np.allclose(base[0], out3[0])


def test_mask_routing_gathers_requested_positions():
    cfg = _cfg()
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    a = model.apply(params, feats, pos)
    # gathering the same position twice must produce identical rows
    pos2 = jnp.stack([pos[:, 0]] * 4, axis=1)
    b = model.apply(params, feats, pos2)
    np.testing.assert_allclose(
        np.asarray(b[:, 0]), np.asarray(b[:, 1]), rtol=1e-6
    )
    np.testing.assert_allclose(np.asarray(a[:, 0]), np.asarray(b[:, 0]), rtol=1e-6)


def test_segment_routing():
    cfg = _cfg(routing="segment", segment_bounds=(0, 1), head=HeadConfig("binary", (8,)))
    model = ClickstreamModel(cfg)
    feats, _ = _batch()
    params = model.init(jax.random.PRNGKey(0), feats)
    logits = model.apply(params, feats)
    assert logits.shape == (3, 1)  # CLS summary -> binary logit


def test_multivariable_concat():
    """(action, item) pairs: two features embedded separately and
    concatenated; d_model = sum of dims (reference transformer.py:336-390)."""
    cfg = _cfg(
        features={
            "items": FeatureConfig(51, 16),
            "events": FeatureConfig(15, 8),
        },
    )
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    feats = dict(feats, events=jnp.clip(feats["items"], 0, 14))
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)
    assert cfg.d_model == 24


def test_tied_softmax_head():
    cfg = _cfg(head=HeadConfig("tied_softmax"))
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)  # V = 51 - 10 - 1
    # no separate output-projection parameters: only embed + encoder
    names = jax.tree_util.tree_leaves_with_path(params)
    assert not any("head" in jax.tree_util.keystr(p) for p, _ in names)


def test_tied_softmax_responds_to_embedding():
    cfg = _cfg(head=HeadConfig("tied_softmax"))
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    logits = model.apply(params, feats, pos)
    params2 = jax.tree.map(lambda x: x, params)
    emb = params2["params"]["embed_items"]["embedding"]
    params2["params"]["embed_items"]["embedding"] = emb.at[NUM_RESERVED_TOKENS + 5].mul(
        2.0
    )
    logits2 = model.apply(params2, feats, pos)
    assert not np.allclose(np.asarray(logits[..., 5]), np.asarray(logits2[..., 5]))


def test_learned_positions():
    cfg = _cfg(positional="learned")
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    assert "positions" in params["params"]
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)


def test_dropout_train_vs_eval():
    cfg = _cfg()
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    e1 = model.apply(params, feats, pos, deterministic=True)
    e2 = model.apply(params, feats, pos, deterministic=True)
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
    t1 = model.apply(
        params, feats, pos, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)}
    )
    assert not np.allclose(np.asarray(e1), np.asarray(t1))


def test_bfloat16_compute():
    cfg = _cfg(dtype="bfloat16")
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    # params stay f32
    assert params["params"]["embed_items"]["embedding"].dtype == jnp.float32
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)


def test_config_json_roundtrip():
    cfg = _cfg()
    cfg2 = ModelConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_config_json_roundtrip_keeps_all_head_fields():
    # regression: from_json rebuilt HeadConfig field-by-field and silently
    # dropped tied_bias, so a tied_bias export could not be served
    cfg = ModelConfig(
        features={"items": FeatureConfig(50, 8)},
        head=HeadConfig("tied_softmax", output_size=39, tied_bias=True),
        max_len=10,
    )
    cfg2 = ModelConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    assert cfg2.head.tied_bias is True


def test_config_validation():
    with pytest.raises(ValueError):
        ModelConfig(routing="segment")  # missing bounds
    with pytest.raises(ValueError):
        HeadConfig(kind="nope")


def test_tied_logits_respect_output_size_with_padded_rows():
    """Padded tables: dense tied logits must cover exactly V rows, never the
    OOV/padding rows (code-review finding)."""
    v = 40
    rows = 64  # 10 reserved + 40 vocab + 1 OOV + 13 padding
    cfg = _cfg(
        features={"items": FeatureConfig(rows, 16)},
        head=HeadConfig("tied_softmax", output_size=v),
    )
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, v)


def test_segment_embeddings_option():
    """Segment embeddings over cumulative SEP markers (the reference
    scaffolded these, transformer.py:392-395; here they are a real option)."""
    cfg = _cfg(use_segment_embeddings=True)
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    assert "segment_embed" in params["params"]
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)
    # zeroing the segment table must change outputs
    params2 = jax.tree.map(lambda x: x, params)
    params2["params"]["segment_embed"]["embedding"] = (
        params2["params"]["segment_embed"]["embedding"] * 0.0
    )
    logits2 = model.apply(params2, feats, pos)
    assert not np.allclose(np.asarray(logits), np.asarray(logits2))


def test_tied_transform_head():
    """BERT-MLM-style transform before the tied projection."""
    cfg = _cfg(head=HeadConfig("tied_softmax", (32, 16), output_size=40))
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    p = params["params"]
    assert "tied_transform_0" in p and "tied_transform_ln" in p
    assert "tied_proj" not in p  # final dim 16 == d_item 16
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)
    # fused-CE input path applies the same transform
    gathered = model.apply(params, feats, pos, method="gather_head_inputs")
    table = p["embed_items"]["embedding"]
    manual = jnp.einsum(
        "bpd,vd->bpv", gathered, table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + 40]
    )
    np.testing.assert_allclose(
        np.asarray(manual), np.asarray(logits), rtol=1e-4, atol=1e-5
    )


def test_tied_multifeature_projection():
    """Multi-variable features widen d_model; tied head projects down via
    tied_proj (was latent-broken inline Dense)."""
    cfg = _cfg(
        features={"items": FeatureConfig(51, 16), "events": FeatureConfig(15, 8)},
        head=HeadConfig("tied_softmax", output_size=40),
    )
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    feats = dict(feats, events=jnp.clip(feats["items"], 0, 14))
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    assert "tied_proj" in params["params"]
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)


def test_factorized_input_projection():
    """encoder_dim (ALBERT-style factorized input): a 16-dim item table feeds
    a 32-wide encoder through input_proj; the tied head's width-matching
    tied_proj maps back to table space. Decouples table capacity from
    encoder width (the flagship 4L/256d overfitting lever)."""
    cfg = _cfg(encoder_dim=32, head=HeadConfig("tied_softmax"))
    assert cfg.d_model == 32
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    assert "input_proj" in params["params"]
    assert params["params"]["input_proj"]["kernel"].shape == (16, 32)
    # tied head needs the 32 -> 16 width-matching projection
    assert params["params"]["tied_proj"]["kernel"].shape == (32, 16)
    logits = model.apply(params, feats, pos)
    assert logits.shape == (3, 4, 40)

    # the projection must receive gradient (it sits on the only input path)
    def loss(p):
        out = model.apply(p, feats, pos)
        return jnp.sum(out * out)

    g = jax.grad(loss)(params)
    assert float(jnp.abs(g["params"]["input_proj"]["kernel"]).sum()) > 0


def test_factorized_input_identity_when_equal():
    """encoder_dim equal to the concatenated embedding width allocates no
    projection — the config is a no-op, not an extra matmul."""
    cfg = _cfg(encoder_dim=16)
    model = ClickstreamModel(cfg)
    feats, pos = _batch()
    params = model.init(jax.random.PRNGKey(0), feats, pos)
    assert "input_proj" not in params["params"]
    base = ClickstreamModel(_cfg())
    want = base.apply(params, feats, pos)
    got = model.apply(params, feats, pos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_tied_bias_output():
    """tied_bias adds a free per-item logit bias (BERT MLM-decoder style):
    zero-init leaves logits unchanged; a bumped bias shifts exactly that
    item's logit everywhere, and the chunked eval path sees the same bias."""
    from bert4clickpath.ops.chunked_eval import chunked_eval_stats, pick_chunk

    cfg = _cfg(head=HeadConfig("tied_softmax", tied_bias=True))
    model = ClickstreamModel(cfg)
    feats = {"items": jnp.asarray(np.full((2, 7), 12, np.int32))}
    pos = jnp.zeros((2, 3), jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(0)}, feats, pos)
    base = model.apply(params, feats, pos)
    assert "tied_out_bias" in params["params"]

    bumped = jax.tree_util.tree_map(lambda x: x, params)
    b = np.zeros(base.shape[-1], np.float32)
    b[3] = 5.0
    bumped["params"]["tied_out_bias"] = jnp.asarray(b)
    out = model.apply(bumped, feats, pos)
    np.testing.assert_allclose(
        np.asarray(out - base)[..., 3], 5.0, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out - base)[..., :3], 0.0, atol=1e-5
    )

    # chunked eval must score with the same bias: compare label_logit-driven
    # loss sums between dense and chunked paths
    from bert4clickpath.constants import NUM_RESERVED_TOKENS
    from bert4clickpath.ops.losses import masked_softmax_cross_entropy

    labels = jnp.asarray(np.array([[3, -1, -1], [0, 1, -1]], np.int32))
    gathered = model.apply(
        bumped, feats, pos, deterministic=True, method="gather_head_inputs"
    )
    table = bumped["params"]["embed_items"]["embedding"]
    v = base.shape[-1]
    full_bias = jnp.zeros((table.shape[0],), jnp.float32)
    full_bias = full_bias.at[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + v].set(
        bumped["params"]["tied_out_bias"]
    )
    stats = chunked_eval_stats(
        gathered, table, labels,
        row_offset=NUM_RESERVED_TOKENS, num_valid=v,
        chunk=pick_chunk(table.shape[0]), bias=full_bias,
    )
    dense_loss = masked_softmax_cross_entropy(
        model.apply(bumped, feats, pos), labels
    )
    n = float(stats["n"])
    assert np.isclose(float(stats["loss_sum"]) / n, float(dense_loss), rtol=1e-5)


def test_qkv_fused_model_trains_and_tp_rejects():
    """qkv_fused=True: one (D, 3D) wqkv projection replaces wq/wk/wv; the
    model trains (finite falling loss) and the TP tier rejects the config
    (its column-split specs are per-projection)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from bert4clickpath import (
        ClickstreamModel,
        FeatureConfig,
        HeadConfig,
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.data.pipeline import ClozeDataset
    from bert4clickpath.parallel import tp
    from bert4clickpath.parallel.mesh import make_mesh
    from bert4clickpath.training import schedules
    from bert4clickpath.training.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    gen = ClickStreamGenerator(n_items=64, seed=0)
    vocab = gen.item_vocab()
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2, num_heads=2, ffn_dim=64, max_len=23,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
        qkv_fused=True,
    )
    # JSON round-trip keeps the field
    assert ModelConfig.from_json(cfg.to_json()).qkv_fused is True

    model = ClickstreamModel(cfg)
    items, _ = gen.generate_sessions(16)
    ds = ClozeDataset(items, vocab, max_items=20)
    it = ds.train_batches(8, seed=0)
    b = next(it)
    batch = {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        batch["features"], batch["head_positions"],
    )
    layer0 = params["params"]["encoder"]["layer_0"]["mha"]
    assert "wqkv" in layer0 and "wq" not in layer0
    assert layer0["wqkv"]["kernel"].shape == (32, 96)

    tx = make_optimizer(TrainConfig(batch_size=8))
    step = make_train_step(model, tx, schedules.constant(1e-2))
    state = TrainState.create(params, tx)
    losses = []
    rng = jax.random.PRNGKey(1)
    for _ in range(12):
        state, loss = step(state, batch, rng)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

    mesh = make_mesh(MeshConfig(data=4, model=2))
    with pytest.raises(ValueError, match="qkv_fused"):
        tp.make_tp_train_step(
            model, tx, schedules.constant(1e-2), mesh
        )

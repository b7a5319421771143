"""Parallel-tier tests on the 8-device virtual CPU mesh: sharded embedding
lookup, vocab-parallel CE, distributed top-k, and the full SPMD train step
vs the single-device reference path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.ops.losses import masked_softmax_cross_entropy
from bert4clickpath.parallel import embedding as emb_ops
from bert4clickpath.parallel import spmd
from bert4clickpath.parallel.mesh import make_mesh
from bert4clickpath.training.train_state import (
    TrainState,
    make_optimizer,
    make_train_step as make_train_step_single,
)
from bert4clickpath.training import schedules

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mesh(data=2, model=4):
    return make_mesh(MeshConfig(data=data, model=model))


def test_sharded_lookup_matches_dense():
    mesh = _mesh()
    rng = np.random.default_rng(0)
    table = rng.normal(size=(32, 8)).astype(np.float32)  # 32 rows / 4 shards
    ids = rng.integers(0, 32, size=(4, 6)).astype(np.int32)

    def f(table_shard, ids):
        return emb_ops.sharded_embedding_lookup(table_shard, ids, "model")

    out = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P("model", None), P("data", None)),
            out_specs=P("data", None, None),
            check_vma=False,
        )
    )(table, ids)
    np.testing.assert_allclose(np.asarray(out), table[ids], rtol=1e-6)


def test_sharded_ce_matches_dense():
    mesh = _mesh()
    rng = np.random.default_rng(1)
    v_rows, d = 32, 8  # model-space rows (padded), divisible by 4
    num_valid = 15  # raw vocab size
    table = rng.normal(size=(v_rows, d)).astype(np.float32)
    x = rng.normal(size=(4, 3, d)).astype(np.float32)
    labels = rng.integers(0, num_valid, size=(4, 3)).astype(np.int32)
    labels[0, 2] = LABEL_PAD
    labels[2, :] = LABEL_PAD

    def f(x, table_shard, labels):
        return emb_ops.sharded_softmax_cross_entropy(
            x,
            table_shard,
            labels,
            row_offset=NUM_RESERVED_TOKENS,
            num_valid=num_valid,
        )

    got = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P("data", None, None), P("model", None), P("data", None)),
            out_specs=P(),
            check_vma=False,
        )
    )(x, table, labels)

    # dense reference: logits over the valid label rows only
    dense_logits = np.einsum(
        "bpd,vd->bpv", x, table[NUM_RESERVED_TOKENS : NUM_RESERVED_TOKENS + num_valid]
    )
    want = masked_softmax_cross_entropy(jnp.asarray(dense_logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sharded_topk_matches_dense():
    mesh = _mesh(data=1, model=8)
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 40)).astype(np.float32)  # vocab 40 / 8 shards

    def f(logits_local):
        vals, idx = emb_ops.sharded_top_k(logits_local, 5, "model")
        return vals, idx

    vals, idx = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P(None, "model"),),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )(logits)
    want_idx = np.argsort(-logits, axis=-1)[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), want_idx)
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(logits, want_idx, axis=-1), rtol=1e-6
    )


def _spmd_setup(n_items=22, d=16, mesh_shape=(2, 4)):
    mesh = _mesh(*mesh_shape)
    gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, mesh_shape[1])
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, d)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,  # exact single-vs-multi comparison
        head=HeadConfig("tied_softmax"),
    )
    return mesh, ds, vocab, cfg


def _device_batch(batch):
    return {
        "features": {k: jnp.asarray(v) for k, v in batch.features.items()},
        "head_positions": jnp.asarray(batch.head_positions),
        "labels": jnp.asarray(batch.labels),
    }


def test_spmd_train_step_matches_single_device():
    mesh, ds, vocab, cfg = _spmd_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)

    # single-device loss at the same params (dense tied head blinds nothing
    # because padding rows exist: compare against dense CE over valid rows)
    from bert4clickpath.parallel.embedding import NEG_BIG  # noqa: F401

    # dense reference loss FIRST (the SPMD step donates the state buffers):
    # full forward with the tied head on one device. The model's tied head
    # uses rows [10, 10+V_table) where V_table = rows-10-1 includes the OOV
    # row + divisibility padding; restrict to the true vocab.
    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    dense = logits[..., : vocab.label_vocab_size]
    want = float(masked_softmax_cross_entropy(dense, b["labels"]))

    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    sharded_state = spmd.shard_state(state, mesh, cfg)
    sharded_batch = spmd.shard_batch(b, mesh, cfg)
    new_state, loss = step(sharded_state, sharded_batch, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    assert int(np.asarray(new_state.step)) == 1


def test_spmd_training_learns():
    mesh, ds, vocab, cfg = _spmd_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b0 = _device_batch(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )["params"]
    tx = make_optimizer(tcfg)
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    rng = jax.random.PRNGKey(1)
    it = ds.train_batches(16, seed=1)
    first = None
    for i in range(30):
        state, loss = step(state, spmd.shard_batch(_device_batch(next(it)), mesh, cfg), rng)
        if first is None:
            first = float(loss)
    assert float(loss) < first


def test_spmd_eval_step():
    mesh, ds, vocab, cfg = _spmd_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    ev = spmd.make_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)
    stats = ev(params, spmd.shard_batch(b, mesh, cfg))
    stats = {k: float(np.asarray(v)) for k, v in stats.items()}
    n_valid = int((np.asarray(b["labels"]) != LABEL_PAD).sum())
    assert stats["n"] == n_valid
    assert 0.0 <= stats["recall@10_sum"] <= stats["n"]
    # sanity vs dense ranking on one device
    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    from bert4clickpath.ops.metrics import ranking_stats

    dense = ranking_stats(
        logits[..., : vocab.label_vocab_size], b["labels"], ks=(5, 10)
    )
    np.testing.assert_allclose(
        stats["recall@10_sum"], float(dense["recall@10_sum"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        stats["ndcg@10_sum"], float(dense["ndcg@10_sum"]), rtol=1e-5
    )


def test_spmd_step_update_matches_manual_single_device():
    """After the psum-grads fix: one SPMD step must produce the same params
    as a manually computed single-device global-mean-loss Adam step."""
    import optax

    mesh, ds, vocab, cfg = _spmd_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    tx = make_optimizer(tcfg)
    lr = 1e-2

    def manual_loss(p):
        logits = model.apply({"params": p}, b["features"], b["head_positions"])
        dense = logits[..., : vocab.label_vocab_size]
        return masked_softmax_cross_entropy(dense, b["labels"])

    grads = jax.grad(manual_loss)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, jax.tree.map(lambda u: u * lr, updates))

    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(lr), vocab.label_vocab_size
    )
    new_state, _ = step(state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1))
    got = jax.device_get(new_state.params)

    def compare(g, a, bb):
        # wk.bias has a mathematically-zero gradient (a constant key shift
        # cancels in softmax); Adam turns its 1e-12 float noise into ±lr, so
        # zero-grad leaves can't be compared through the optimizer.
        if float(np.abs(np.asarray(g)).max()) < 1e-6:
            return
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(bb), rtol=5e-4, atol=1e-6
        )

    jax.tree.map(compare, jax.device_get(grads), got, jax.device_get(want))


def test_spmd_transform_and_segments_match_single_device():
    """Tied-head transform (incl. the width-matching tied_proj) and segment
    embeddings must flow through the SPMD forward identically to the
    single-chip model (the round-1 asserts are gone)."""
    mesh, ds, vocab, _ = _spmd_setup()
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 4)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        use_segment_embeddings=True,
        # last width 24 != d_item 16 -> exercises tied_proj too
        head=HeadConfig("tied_softmax", dense_dims=(24,)),
    )
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    # make segment embeddings distinctive so dropping them would show
    params["segment_embed"]["embedding"] = (
        params["segment_embed"]["embedding"] + 0.7
    )

    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    want = float(
        masked_softmax_cross_entropy(
            logits[..., : vocab.label_vocab_size], b["labels"]
        )
    )
    params0 = jax.device_get(params)  # host snapshot: the step donates
    tcfg = TrainConfig()
    tx = make_optimizer(tcfg)
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    new_state, loss = step(
        state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1)
    )
    np.testing.assert_allclose(float(loss), want, rtol=2e-4)
    # the transform/segment params must actually receive gradient: one step
    # at lr=1e-2 must move them
    got = jax.device_get(new_state.params)
    assert not np.allclose(
        got["tied_transform_0"]["kernel"], params0["tied_transform_0"]["kernel"]
    )
    assert not np.allclose(
        got["segment_embed"]["embedding"], params0["segment_embed"]["embedding"]
    )

    # eval goes through the same forward
    ev = spmd.make_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)
    stats = ev(params0, spmd.shard_batch(b, mesh, cfg))
    from bert4clickpath.ops.metrics import ranking_stats

    dense = ranking_stats(
        logits[..., : vocab.label_vocab_size], b["labels"], ks=(5, 10)
    )
    np.testing.assert_allclose(
        float(stats["ndcg@10_sum"]), float(dense["ndcg@10_sum"]), rtol=1e-5
    )


def _parity_head_setup(mesh_shape=(8, 1)):
    mesh = _mesh(*mesh_shape)
    gen = ClickStreamGenerator(n_items=22, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        # the reference's own model: MLP softmax head (source/main.py:262)
        head=HeadConfig("softmax", (32, 24), vocab.label_vocab_size),
    )
    return mesh, ds, vocab, cfg


def test_dp_parity_head_step_matches_single_device():
    """Pure-DP step over 8 devices == single-device global-mean Adam step
    for the reference parity MLP-softmax model (its MirroredStrategy
    equivalent, source/main.py:46-57)."""
    import optax

    mesh, ds, vocab, cfg = _parity_head_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )
    tx = make_optimizer(tcfg)
    lr = 1e-2

    def manual_loss(v):
        logits = model.apply(v, b["features"], b["head_positions"])
        return masked_softmax_cross_entropy(logits, b["labels"])

    want_loss = float(manual_loss(variables))
    grads = jax.grad(manual_loss)(variables)
    updates, _ = tx.update(grads, tx.init(variables), variables)
    want = optax.apply_updates(variables, jax.tree.map(lambda u: u * lr, updates))

    state = spmd.replicate_state(TrainState.create(variables, tx), mesh)
    step = spmd.make_dp_train_step(model, mesh, tx, schedules.constant(lr))
    new_state, loss = step(
        state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1)
    )
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-5)

    def compare(g, a, bb):
        if float(np.abs(np.asarray(g)).max()) < 1e-6:
            return  # zero-grad leaves: Adam amplifies float noise to ±lr
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(bb), rtol=5e-4, atol=1e-6
        )

    jax.tree.map(
        compare,
        jax.device_get(grads),
        jax.device_get(new_state.params),
        jax.device_get(want),
    )


def test_dp_eval_step_matches_single_device():
    from bert4clickpath.training.train_state import make_eval_step

    mesh, ds, vocab, cfg = _parity_head_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )
    ev = spmd.make_dp_eval_step(model, mesh)
    stats = {k: float(np.asarray(v)) for k, v in ev(variables, spmd.shard_batch(b, mesh, cfg)).items()}
    single = make_eval_step(model)(variables, b)
    for k in ("n", "loss_sum", "recall@10_sum", "ndcg@10_sum"):
        np.testing.assert_allclose(
            stats[k], float(np.asarray(single[k])), rtol=1e-4, err_msg=k
        )


def test_dp_training_learns_parity_head():
    mesh, ds, vocab, cfg = _parity_head_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b0 = _device_batch(next(ds.train_batches(16, seed=0)))
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = spmd.replicate_state(TrainState.create(variables, tx), mesh)
    step = spmd.make_dp_train_step(model, mesh, tx, schedules.constant(1e-2))
    it = ds.train_batches(16, seed=1)
    first = None
    for _ in range(30):
        state, loss = step(
            state, spmd.shard_batch(_device_batch(next(it)), mesh, cfg),
            jax.random.PRNGKey(1),
        )
        if first is None:
            first = float(loss)
    assert float(loss) < first


def test_spmd_learned_positions_match_single_device():
    """The SPMD forward must honor positional='learned' (was silently
    falling back to sinusoidal)."""
    mesh = _mesh()
    gen = ClickStreamGenerator(n_items=22, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(32)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 4)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        positional="learned",
        head=HeadConfig("tied_softmax"),
    )
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    # make the learned table distinctive so a fallback would show
    params["positions"]["embedding"] = params["positions"]["embedding"] + 1.5

    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    want = float(
        masked_softmax_cross_entropy(
            logits[..., : vocab.label_vocab_size], b["labels"]
        )
    )
    tcfg = TrainConfig()
    tx = make_optimizer(tcfg)
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(0.0), vocab.label_vocab_size
    )
    _, loss = step(state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(loss), want, rtol=2e-4)


def test_spmd_factorized_input_matches_single_device():
    """encoder_dim (factorized input projection) must flow through the SPMD
    forward identically to the single-chip model: 16-dim sharded table ->
    input_proj -> 32-wide encoder -> tied_proj -> vocab-parallel CE."""
    mesh, ds, vocab, _ = _spmd_setup()
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 4)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        encoder_dim=32,
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        head=HeadConfig("tied_softmax"),
    )
    assert cfg.d_model == 32
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]

    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    want = float(
        masked_softmax_cross_entropy(
            logits[..., : vocab.label_vocab_size], b["labels"]
        )
    )
    params0 = jax.device_get(params)
    tx = make_optimizer(TrainConfig())
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    new_state, loss = step(
        state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1)
    )
    np.testing.assert_allclose(float(loss), want, rtol=2e-4)
    got = jax.device_get(new_state.params)
    # both projections sit on the only forward path -> must move
    assert not np.allclose(
        got["input_proj"]["kernel"], params0["input_proj"]["kernel"]
    )
    assert not np.allclose(
        got["tied_proj"]["kernel"], params0["tied_proj"]["kernel"]
    )

    ev = spmd.make_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)
    stats = ev(params0, spmd.shard_batch(b, mesh, cfg))
    from bert4clickpath.ops.metrics import ranking_stats

    dense = ranking_stats(
        logits[..., : vocab.label_vocab_size], b["labels"], ks=(5, 10)
    )
    np.testing.assert_allclose(
        float(stats["ndcg@10_sum"]), float(dense["ndcg@10_sum"]), rtol=1e-5
    )


def test_dp_fused_parity_head_step_matches_single_device():
    """DP + fused Pallas CE for the MLP softmax head == the single-device
    dense-logits global-mean Adam step (local fused sums, psum outside
    autodiff)."""
    import optax

    mesh, ds, vocab, cfg = _parity_head_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )
    tx = make_optimizer(tcfg)
    lr = 1e-2

    def manual_loss(v):
        logits = model.apply(v, b["features"], b["head_positions"])
        return masked_softmax_cross_entropy(logits, b["labels"])

    want_loss = float(manual_loss(variables))
    grads = jax.grad(manual_loss)(variables)
    updates, _ = tx.update(grads, tx.init(variables), variables)
    want = optax.apply_updates(variables, jax.tree.map(lambda u: u * lr, updates))

    state = spmd.replicate_state(TrainState.create(variables, tx), mesh)
    step = spmd.make_dp_train_step(
        model, mesh, tx, schedules.constant(lr),
        fused_ce_num_valid=vocab.label_vocab_size,
    )
    new_state, loss = step(
        state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1)
    )
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-5)

    def compare(g, a, bb):
        if float(np.abs(np.asarray(g)).max()) < 1e-6:
            return  # zero-grad leaves: Adam amplifies float noise to ±lr
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(bb), rtol=5e-4, atol=1e-6
        )

    jax.tree.map(
        compare,
        jax.device_get(grads),
        jax.device_get(new_state.params),
        jax.device_get(want),
    )


def _spmd_bias_setup(n_items=22, d=16, mesh_shape=(2, 4)):
    mesh = _mesh(*mesh_shape)
    gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, mesh_shape[1])
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, d)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        head=HeadConfig(
            "tied_softmax", output_size=vocab.label_vocab_size, tied_bias=True
        ),
    )
    return mesh, ds, vocab, cfg


def test_spmd_tied_bias_step_matches_manual_single_device():
    """tied_bias under vocab sharding: one SPMD step (bias-carrying sharded
    fused CE, replicated-bias psum'd VJP) == the manual single-device
    dense-logits Adam step, including the bias update."""
    import optax

    mesh, ds, vocab, cfg = _spmd_bias_setup()
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    # give the bias non-zero values so the forward exercises it too
    params = dict(params)
    params["tied_out_bias"] = (
        0.1 * jax.random.normal(jax.random.PRNGKey(7), (vocab.label_vocab_size,))
    )
    tx = make_optimizer(tcfg)
    lr = 1e-2

    def manual_loss(p):
        logits = model.apply({"params": p}, b["features"], b["head_positions"])
        return masked_softmax_cross_entropy(logits, b["labels"])

    want_loss = float(manual_loss(params))
    grads = jax.grad(manual_loss)(params)
    assert float(np.abs(np.asarray(grads["tied_out_bias"])).max()) > 1e-6
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, jax.tree.map(lambda u: u * lr, updates))

    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(lr), vocab.label_vocab_size
    )
    new_state, loss = step(state, spmd.shard_batch(b, mesh, cfg), jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-4)
    got = jax.device_get(new_state.params)

    def compare(g, a, bb):
        if float(np.abs(np.asarray(g)).max()) < 1e-6:
            return  # zero-grad leaves: Adam amplifies float noise to ±lr
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(bb), rtol=5e-4, atol=1e-6
        )

    jax.tree.map(compare, jax.device_get(grads), got, jax.device_get(want))


def test_spmd_tied_bias_eval_matches_dense():
    mesh, ds, vocab, cfg = _spmd_bias_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    params = dict(params)
    params["tied_out_bias"] = (
        0.5 * jax.random.normal(jax.random.PRNGKey(9), (vocab.label_vocab_size,))
    )
    ev = spmd.make_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)
    stats = {
        k: float(np.asarray(v))
        for k, v in ev(params, spmd.shard_batch(b, mesh, cfg)).items()
    }
    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    from bert4clickpath.ops.metrics import ranking_stats

    dense = ranking_stats(logits, b["labels"], ks=(5, 10))
    for k in ("recall@10_sum", "ndcg@10_sum", "recall@5_sum", "ndcg@5_sum"):
        np.testing.assert_allclose(
            stats[k], float(np.asarray(dense[k])), rtol=1e-5, err_msg=k
        )


# -- tensor-parallel (pjit auto-sharding) tier ------------------------------


def _tp_setup(head_kind="tied_softmax", dropout=0.0):
    gen = ClickStreamGenerator(n_items=40, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(96)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=16)
    head = (
        HeadConfig("tied_softmax", tied_bias=True)
        if head_kind == "tied_softmax"
        else HeadConfig("softmax", (24,), vocab.label_vocab_size)
    )
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=4,  # divisible by model axis 4 (head-parallel)
        ffn_dim=64,
        dropout_rate=dropout,
        max_len=19,
        head=head,
    )
    return _mesh(), ds, vocab, cfg


def test_tp_train_step_matches_single_device():
    """Megatron-style TP via XLA auto-partitioning must be bit-compatible
    (up to f32 reduction order) with the single-device step: same loss,
    same updated params after one step."""
    from bert4clickpath.parallel import tp

    for head_kind in ("tied_softmax", "softmax"):
        mesh, ds, vocab, cfg = _tp_setup(head_kind)
        model = ClickstreamModel(cfg)
        b = _device_batch(next(ds.train_batches(8, seed=0)))
        params = model.init(
            {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
        )
        tx = make_optimizer(TrainConfig())
        rng = jax.random.PRNGKey(1)

        ref_step = make_train_step_single(model, tx, schedules.constant(1e-2))
        # both steps donate their state buffers: give each its own copy
        ref_state, ref_loss = ref_step(
            TrainState.create(jax.tree.map(jnp.copy, params), tx), b, rng
        )

        tp_step = tp.make_tp_train_step(
            model, tx, schedules.constant(1e-2), mesh
        )
        state = tp.shard_tp_state(TrainState.create(params, tx), mesh, cfg)
        batch = tp.shard_tp_batch(b, mesh, cfg)
        new_state, loss = tp_step(state, batch, rng)

        np.testing.assert_allclose(
            float(loss), float(ref_loss), rtol=2e-5, err_msg=head_kind
        )
        got = jax.device_get(new_state.params)
        want = jax.device_get(ref_state.params)

        def check(path, a, c):
            names = [str(getattr(k, "key", k)) for k in path]
            if "wk" in names and "bias" in names:
                # the key-projection bias has a mathematically ZERO gradient
                # (a constant shift of every key cancels in softmax), so
                # Adam normalizes reduction-order noise (~1e-8) into a full
                # lr-sized step whose sign depends on summation order —
                # check magnitude only
                assert np.abs(a - c).max() <= 2.5e-2, names
                return
            np.testing.assert_allclose(a, c, rtol=3e-4, atol=2e-6, err_msg=names)

        jax.tree_util.tree_map_with_path(check, got, want)


def test_tp_eval_step_matches_single_device():
    from bert4clickpath.parallel import tp
    from bert4clickpath.training.train_state import make_eval_step

    mesh, ds, vocab, cfg = _tp_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.eval_batches(8)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )
    want = jax.device_get(make_eval_step(model)(params, b))
    tp_eval = tp.make_tp_eval_step(model, mesh)
    pspec = jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s),
        tp.tp_param_specs(params, cfg),
        is_leaf=lambda x: isinstance(x, P),
    )
    got = jax.device_get(
        tp_eval(jax.device_put(params, pspec), tp.shard_tp_batch(b, mesh, cfg))
    )
    jax.tree.map(
        lambda a, c: np.testing.assert_allclose(a, c, rtol=2e-5, atol=1e-6),
        got,
        want,
    )


def test_tp_rejects_bad_shapes():
    from bert4clickpath.parallel import tp

    mesh, ds, vocab, cfg = _tp_setup()
    bad = ModelConfig(
        features=cfg.features, num_layers=1, num_heads=3, ffn_dim=64,
        max_len=cfg.max_len, head=cfg.head,
    )
    with pytest.raises(ValueError):
        tp.make_tp_train_step(
            ClickstreamModel(bad), make_optimizer(TrainConfig()),
            schedules.constant(1e-2), mesh,
        )


def test_spmd_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Failure-recovery rehearsal for the sharded tier: save mid-training,
    restore on host, re-shard over the mesh, continue — the resumed run's
    losses must equal the uninterrupted run step for step."""
    from bert4clickpath.training import checkpoint as ckpt_lib

    mesh, ds, vocab, cfg = _spmd_setup()
    model = ClickstreamModel(cfg)
    batches = []
    it = ds.train_batches(8, seed=0)
    for _ in range(4):
        batches.append(spmd.shard_batch(_device_batch(next(it)), mesh, cfg))
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        jax.device_get(batches[0]["features"]),
        jax.device_get(batches[0]["head_positions"]),
    )["params"]
    tx = make_optimizer(TrainConfig())
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    rng = jax.random.PRNGKey(1)

    # uninterrupted: 4 steps
    state = spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    want_losses = []
    for b in batches:
        state, loss = step(state, b, rng)
        want_losses.append(float(loss))

    # interrupted: 2 steps -> checkpoint -> restore -> re-shard -> 2 more
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    for b in batches[:2]:
        state, loss = step(state, b, rng)
    host_state = jax.device_get(state)
    ckpt_lib.save_checkpoint(str(tmp_path / "ckpts"), host_state, 2)
    del state

    path = ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts"))
    assert path is not None and path.endswith("2")
    restored = ckpt_lib.restore_state(path, jax.tree.map(np.asarray, host_state))
    resumed = spmd.shard_state(restored, mesh, cfg)
    assert int(np.asarray(resumed.step)) == 2
    got_losses = []
    for b in batches[2:]:
        resumed, loss = step(resumed, b, rng)
        got_losses.append(float(loss))
    np.testing.assert_allclose(got_losses, want_losses[2:], rtol=1e-6)


def test_dp_chunked_eval_matches_single_device():
    """DP eval with the chunked catalog scan (no (B_local, P, V) logits)
    == the single-device chunked eval — both head kinds."""
    from bert4clickpath.training.train_state import make_eval_step

    for setup in (_parity_head_setup, _spmd_setup):
        if setup is _spmd_setup:
            mesh, ds, vocab, cfg = _spmd_setup(mesh_shape=(8, 1))
        else:
            mesh, ds, vocab, cfg = setup()
        model = ClickstreamModel(cfg)
        b = _device_batch(next(ds.train_batches(8, seed=0)))
        variables = model.init(
            {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
        )
        v = vocab.label_vocab_size
        ev = spmd.make_dp_eval_step(model, mesh, chunked_num_valid=v)
        stats = ev(variables, spmd.shard_batch(b, mesh, cfg))
        single = make_eval_step(model, chunked_num_valid=v)(variables, b)
        for k in ("n", "loss_sum", "recall@10_sum", "ndcg@10_sum"):
            np.testing.assert_allclose(
                float(np.asarray(stats[k])),
                float(np.asarray(single[k])),
                rtol=1e-4,
                err_msg=f"{setup.__name__}:{k}",
            )


def test_dp_scan_step_matches_sequential():
    """DP scan variant (K steps per dispatch inside shard_map) == K
    sequential DP steps: same losses, same final params."""
    from bert4clickpath.data.cloze import stack_batches

    mesh, ds, vocab, cfg = _parity_head_setup()
    model = ClickstreamModel(cfg)
    it = ds.train_batches(8, seed=0)
    host = [next(it) for _ in range(3)]
    b0 = _device_batch(host[0])
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    seq = spmd.make_dp_train_step(model, mesh, tx, schedules.constant(1e-2))
    state = spmd.replicate_state(
        TrainState.create(jax.tree.map(jnp.copy, variables), tx), mesh
    )
    seq_losses = []
    for hb in host:
        state, loss = seq(state, spmd.shard_batch(_device_batch(hb), mesh, cfg), rng)
        seq_losses.append(float(loss))
    seq_state = state

    scan = spmd.make_dp_train_step(
        model, mesh, tx, schedules.constant(1e-2), steps_per_call=3
    )
    stacked = spmd.shard_stacked_batch(
        {
            "features": {
                k: np.stack([hb.features[k] for hb in host])
                for k in host[0].features
            },
            "head_positions": np.stack([hb.head_positions for hb in host]),
            "labels": np.stack([hb.labels for hb in host]),
        },
        mesh,
        cfg,
    )
    state2 = spmd.replicate_state(TrainState.create(variables, tx), mesh)
    state2, losses = scan(state2, stacked, rng)
    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-5)
    assert int(np.asarray(state2.step)) == 3
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        ),
        jax.device_get(state2.params),
        jax.device_get(seq_state.params),
    )


def test_spmd_scan_step_matches_sequential():
    """SPMD (vocab-sharded fused-CE) scan variant == K sequential steps."""
    mesh, ds, vocab, cfg = _spmd_setup()
    it = ds.train_batches(8, seed=0)
    host = [next(it) for _ in range(3)]
    b0 = _device_batch(host[0])
    model = ClickstreamModel(cfg)
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )["params"]
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    seq = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    state = spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    seq_losses = []
    for hb in host:
        state, loss = seq(
            state, spmd.shard_batch(_device_batch(hb), mesh, cfg), rng
        )
        seq_losses.append(float(loss))
    seq_state = state

    scan = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size,
        steps_per_call=3,
    )
    stacked = spmd.shard_stacked_batch(
        {
            "features": {
                k: np.stack([hb.features[k] for hb in host])
                for k in host[0].features
            },
            "head_positions": np.stack([hb.head_positions for hb in host]),
            "labels": np.stack([hb.labels for hb in host]),
        },
        mesh,
        cfg,
    )
    state2 = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    state2, losses = scan(state2, stacked, rng)
    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-5)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        ),
        jax.device_get(state2.params),
        jax.device_get(seq_state.params),
    )


def test_spmd_train_step_qkv_fused_matches_single_device():
    """The vocab-sharded tier with qkv_fused=True (one wqkv projection):
    sharded loss == the dense single-device loss at the same params."""
    mesh, ds, vocab, cfg = _spmd_setup()
    import dataclasses

    cfg = dataclasses.replace(cfg, qkv_fused=True)
    tcfg = TrainConfig()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    assert "wqkv" in params["encoder"]["layer_0"]["mha"]
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)

    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    dense = logits[..., : vocab.label_vocab_size]
    want = float(masked_softmax_cross_entropy(dense, b["labels"]))

    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    new_state, loss = step(
        spmd.shard_state(state, mesh, cfg),
        spmd.shard_batch(b, mesh, cfg),
        jax.random.PRNGKey(1),
    )
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    assert int(np.asarray(new_state.step)) == 1


def test_sampled_spmd_matches_single_device():
    """Sampled-softmax training over the row-sharded table (pjit
    auto-sharding) == the single-device sampled step: same rng => same
    negatives => same loss and params trajectory."""
    from bert4clickpath.training.train_state import make_train_step

    mesh, ds, vocab, cfg = _spmd_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )  # wrapped {"params": ...}: the single-program step applies it directly
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    single = make_train_step(
        model, tx, schedules.constant(1e-2),
        fused_ce_num_valid=vocab.label_vocab_size,
        sampled_softmax_samples=16, donate=False,
    )
    s_state = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    want = []
    for _ in range(3):
        s_state, loss = single(s_state, b, rng)
        want.append(float(loss))

    sharded = spmd.make_sampled_spmd_train_step(
        model, mesh, tx, schedules.constant(1e-2),
        vocab.label_vocab_size, 16, donate=False,
    )
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    batch = spmd.shard_batch(b, mesh, cfg)
    got = []
    for _ in range(3):
        state, loss = sharded(state, batch, rng)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert int(np.asarray(state.step)) == 3


# -- composed TP x vocab-sharded tier (parallel/tp_spmd.py) -----------------


def _tp_spmd_setup(n_items=22, d=16, mesh_shape=(4, 2)):
    """Like _spmd_setup but on a (4, 2) mesh (num_heads=2 must divide the
    model axis for the head-parallel attention split)."""
    mesh = _mesh(*mesh_shape)
    gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, mesh_shape[1])
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, d)},
        num_layers=2,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,  # exact single-vs-multi comparison
        head=HeadConfig("tied_softmax"),
    )
    return mesh, ds, vocab, cfg


def test_tp_spmd_train_step_matches_single_device():
    """Composed tier loss at the same params == dense single-device loss."""
    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    tx = make_optimizer(TrainConfig())
    state = TrainState.create(params, tx)

    logits = model.apply({"params": params}, b["features"], b["head_positions"])
    dense = logits[..., : vocab.label_vocab_size]
    want = float(masked_softmax_cross_entropy(dense, b["labels"]))

    step = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    new_state, loss = step(
        tp_spmd.shard_state(state, mesh, cfg),
        spmd.shard_batch(b, mesh, cfg),
        jax.random.PRNGKey(1),
    )
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    assert int(np.asarray(new_state.step)) == 1


def test_tp_spmd_trajectory_matches_spmd_tier():
    """3 steps of the composed tier == 3 steps of the replicated-encoder
    SPMD tier (same mesh, params, batches): identical losses AND params —
    i.e. the hand-written Megatron f/g VJPs produce exactly the replicated
    gradient."""
    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    model = ClickstreamModel(cfg)
    b0 = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )["params"]
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)
    batches = [b0] + [
        _device_batch(b)
        for _, b in zip(range(2), ds.train_batches(8, seed=2))
    ]

    ref_step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    ref_state = spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    want = []
    for b in batches:
        ref_state, loss = ref_step(ref_state, spmd.shard_batch(b, mesh, cfg), rng)
        want.append(float(loss))

    step = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    state = tp_spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    got = []
    for b in batches:
        state, loss = step(state, spmd.shard_batch(b, mesh, cfg), rng)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)

    def cmp(path, a, b):
        # wk.bias is mathematically degenerate: a constant added to every
        # key shifts each query's scores uniformly, which softmax cancels —
        # its true gradient is exactly 0, so Adam amplifies fp roundoff
        # (~1e-8, different between the two programs) into lr-sized steps
        # in arbitrary directions. Skip it; everything else must match.
        names = [str(getattr(k, "key", k)) for k in path]
        if "wk" in names and "bias" in names:
            return
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6,
            err_msg="/".join(names),
        )

    jax.tree_util.tree_map_with_path(
        cmp, jax.device_get(state.params), jax.device_get(ref_state.params)
    )


def test_tp_spmd_eval_matches_spmd_tier():
    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    want = spmd.make_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)(
        params, spmd.shard_batch(b, mesh, cfg)
    )
    got = tp_spmd.make_tp_spmd_eval_step(cfg, mesh, vocab.label_vocab_size)(
        params, spmd.shard_batch(b, mesh, cfg)
    )
    for k in want:
        np.testing.assert_allclose(
            float(np.asarray(got[k])), float(np.asarray(want[k])), rtol=1e-5,
            err_msg=k,
        )


def test_tp_spmd_scan_matches_sequential():
    """steps_per_call=K on the composed tier == K sequential steps."""
    from bert4clickpath.data.cloze import stack_batches
    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    model = ClickstreamModel(cfg)
    raw = [b for _, b in zip(range(2), ds.train_batches(8, seed=0))]
    b0 = _device_batch(raw[0])
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )["params"]
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    seq_step = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    seq_state = tp_spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    seq_losses = []
    for b in raw:
        seq_state, loss = seq_step(
            seq_state, spmd.shard_batch(_device_batch(b), mesh, cfg), rng
        )
        seq_losses.append(float(loss))

    scan = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size,
        steps_per_call=2,
    )
    state = tp_spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    stacked = spmd.shard_stacked_batch(
        _device_batch(stack_batches(raw)), mesh, cfg
    )
    state, losses = scan(state, stacked, rng)
    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-5)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        ),
        jax.device_get(state.params),
        jax.device_get(seq_state.params),
    )


def test_tp_spmd_bf16_matches_spmd_tier():
    """bf16 composed tier vs bf16 replicated-encoder tier: the row-parallel
    partials accumulate in f32 and all-reduce in f32 (one rounding, after
    the psum), so the two programs stay within bf16 rounding of each other
    — quantifies that drift."""
    import dataclasses

    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = ClickstreamModel(cfg)
    b = _device_batch(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"]
    )["params"]
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    ref_step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    ref_state = spmd.shard_state(
        TrainState.create(jax.tree.map(jnp.copy, params), tx), mesh, cfg
    )
    _, want = ref_step(ref_state, spmd.shard_batch(b, mesh, cfg), rng)

    step = tp_spmd.make_tp_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    state = tp_spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    _, got = step(state, spmd.shard_batch(b, mesh, cfg), rng)
    # bf16 eps ~= 7.8e-3; per-layer roundings compound across 2 layers
    np.testing.assert_allclose(float(got), float(want), rtol=3e-2)


def test_tp_spmd_rejects_bad_combinations():
    from bert4clickpath.parallel import tp_spmd

    mesh, ds, vocab, cfg = _tp_spmd_setup()
    import dataclasses

    tx = make_optimizer(TrainConfig())
    with pytest.raises(ValueError, match="qkv_fused"):
        tp_spmd.make_tp_spmd_train_step(
            dataclasses.replace(cfg, qkv_fused=True), mesh, tx,
            schedules.constant(1e-2), vocab.label_vocab_size,
        )
    with pytest.raises(ValueError, match="num_heads"):
        tp_spmd.make_tp_spmd_train_step(
            dataclasses.replace(cfg, num_heads=3), mesh, tx,
            schedules.constant(1e-2), vocab.label_vocab_size,
        )

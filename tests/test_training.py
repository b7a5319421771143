"""Training-tier tests: schedules, train/eval steps, trainer callbacks,
checkpoint/restore, transfer learning, serving export."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath import (
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.data.generator import ClickStreamGenerator
from bert4clickpath.data.pipeline import ClozeDataset
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.training import schedules
from bert4clickpath.training.serving import ServingModel
from bert4clickpath.training.train_state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath.training.trainer import Trainer
from bert4clickpath.vocab import Vocabulary


def _setup(head_kind="tied_softmax", n_items=30, n_sessions=80):
    gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(n_sessions)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20)
    head = (
        HeadConfig("tied_softmax")
        if head_kind == "tied_softmax"
        else HeadConfig(head_kind, (16,), vocab.label_vocab_size)
    )
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 16)},
        num_layers=1,
        num_heads=1,
        ffn_dim=32,
        max_len=23,
        head=head,
    )
    model = ClickstreamModel(cfg)
    return ds, vocab, cfg, model


def _to_device(batch):
    return {
        "features": {k: jnp.asarray(v) for k, v in batch.features.items()},
        "head_positions": jnp.asarray(batch.head_positions),
        "labels": jnp.asarray(batch.labels),
    }


def test_rsqrt_warmup_single_scale():
    # scale must apply once (reference bug training_utils.py:34-36 fixed)
    s2 = schedules.rsqrt_warmup(64, 100, scale=2.0)
    s1 = schedules.rsqrt_warmup(64, 100, scale=1.0)
    step = jnp.asarray(10)
    assert np.isclose(float(s2(step)), 2.0 * float(s1(step)))


def test_exp_decay_floor():
    s = schedules.exponential_decay_to_floor(1e-2, 1e-4, 10, 0.5)
    assert float(s(jnp.asarray(0))) == pytest.approx(1e-2)
    assert float(s(jnp.asarray(10_000))) == pytest.approx(1e-4, rel=1e-3)


def test_weight_decay_mask():
    # AdamW decay hits dense kernels always; embedding tables / learned
    # positions only under decay_tables=True; biases & LN scales never.
    ds, vocab, cfg, model = _setup()
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    zeros = jax.tree.map(jnp.zeros_like, params)

    def decayed_paths(decay_tables):
        tx = make_optimizer(
            TrainConfig(), weight_decay=0.1, decay_tables=decay_tables
        )
        upd, _ = tx.update(zeros, tx.init(params), params)
        out = set()
        for path, leaf in jax.tree_util.tree_leaves_with_path(upd):
            if float(jnp.abs(leaf).max()) > 0:
                out.add("/".join(str(getattr(k, "key", k)) for k in path))
        return out

    base = decayed_paths(False)
    with_tables = decayed_paths(True)
    assert any("encoder" in p and "kernel" in p for p in base)
    assert not any("embed_items" in p for p in base)
    assert not any("bias" in p for p in base)
    extra = with_tables - base
    assert any("embed_items" in p for p in extra)
    assert not any("bias" in p or "scale" in p for p in with_tables)


def test_train_step_reduces_loss():
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(batch_size=16, steps_per_epoch=30)
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, schedules.constant(1e-2), donate=False)
    rng = jax.random.PRNGKey(1)
    it = ds.train_batches(16, seed=1)
    first = None
    for i in range(40):
        state, loss = step(state, _to_device(next(it)), rng)
        if first is None:
            first = float(loss)
    assert float(loss) < first
    assert int(state.step) == 40


def test_eval_step_stats_keys():
    ds, vocab, cfg, model = _setup()
    b = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"])
    ev = make_eval_step(model)
    stats = ev(params, b)
    assert {"loss_sum", "n", "recall@10_sum", "ndcg@10_sum"} <= set(stats)


def test_trainer_fit_callbacks(tmp_path):
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(
        batch_size=16,
        steps_per_epoch=5,
        n_epochs=3,
        plateau_patience=1,
        plateau_factor=0.5,
        early_stopping_patience=10,
    )
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), donate=False),
        make_eval_step(model),
        tcfg,
        model_dir=str(tmp_path),
        to_device=_to_device,
    )
    state = trainer.fit(
        state,
        ds.train_batches(16, seed=1),
        lambda: ds.eval_batches(16, limit_batches=2),
        jax.random.PRNGKey(2),
    )
    assert len(trainer.history) == 3
    assert "val_recall@10" in trainer.history[0]
    assert os.path.exists(tmp_path / "history.jsonl")
    # a best checkpoint was saved
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts")) is not None


def test_trainer_early_stopping_and_plateau():
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(
        batch_size=16,
        steps_per_epoch=1,
        n_epochs=20,
        plateau_patience=2,
        plateau_factor=0.5,
        early_stopping_patience=4,
    )
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    # LR 0 -> nothing improves after epoch 0 -> plateau cuts + early stop
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(0.0), donate=False),
        make_eval_step(model),
        tcfg,
        to_device=_to_device,
    )
    state = trainer.fit(
        state,
        ds.train_batches(16, seed=1),
        lambda: ds.eval_batches(16, limit_batches=1),
        jax.random.PRNGKey(2),
    )
    records = [r for r in trainer.history if "early_stop" in r]
    assert records, "early stopping should have fired"
    assert float(np.asarray(state.lr_scale)) < 1.0  # plateau reduced LR


def test_checkpoint_roundtrip(tmp_path):
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig()
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpts"), jax.device_get(state), 7)
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts")) == path
    restored = ckpt_lib.restore_state(path, state)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        jax.device_get(state),
        restored,
    )


def test_checkpoint_keep_prunes_oldest(tmp_path):
    """keep=N retains the N newest best-so-far checkpoints (0 = reference
    accumulation); restore from the survivor still round-trips."""
    ds, vocab, cfg, model = _setup()
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = make_optimizer(TrainConfig())
    state = TrainState.create(params, tx)
    d = str(tmp_path / "ckpts")
    host = jax.device_get(state)
    for step in (7, 14, 21, 28):
        ckpt_lib.save_checkpoint(d, host, step, keep=2)
    ckpt_lib.wait_until_finished()
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == ["step_00000021", "step_00000028"], names
    latest = ckpt_lib.latest_checkpoint(d)
    assert latest.endswith("step_00000028")
    restored = ckpt_lib.restore_state(latest, state)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        host,
        restored,
    )
    # keep=0/None keeps everything (reference parity)
    ckpt_lib.save_checkpoint(d, host, 35)
    ckpt_lib.wait_until_finished()
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 3


def test_transfer_learning_encoder_swap_head(tmp_path):
    """Pretrain with tied softmax -> fine-tune a binary head on the same
    encoder (reference fine-tune path, source/main.py:100-120)."""
    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    ckpt_lib.save_params(
        str(tmp_path / "pre"), ckpt_lib.init_params_like_subset(jax.device_get(params))
    )

    cfg2 = ModelConfig(
        features=cfg.features,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        ffn_dim=cfg.ffn_dim,
        max_len=cfg.max_len,
        head=HeadConfig("binary", (8,)),
        routing="segment",
        segment_bounds=(0, 1),
    )
    model2 = ClickstreamModel(cfg2)
    params2 = model2.init({"params": jax.random.PRNGKey(3)}, b0["features"])
    merged = ckpt_lib.restore_encoder(str(tmp_path / "pre"), jax.device_get(params2))
    # encoder + embeddings match the pretrained values
    np.testing.assert_array_equal(
        np.asarray(merged["params"]["embed_items"]["embedding"]),
        np.asarray(params["params"]["embed_items"]["embedding"]),
    )
    # head params exist (fresh)
    assert "head" in merged["params"]
    logits = model2.apply(merged, b0["features"])
    assert logits.shape == (8, 1)


def test_serving_export_roundtrip(tmp_path):
    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir)
    recs = served.recommend([["item_0", "item_1"], ["item_5"]], k=5)
    assert len(recs) == 2 and len(recs[0]) == 5
    names = [n for n, _ in recs[0]]
    assert all(n.startswith("item_") for n in names)
    # scores are log-probs, descending
    scores = [s for _, s in recs[0]]
    assert scores == sorted(scores, reverse=True)


def test_serving_rebuild_honors_norm_style(tmp_path):
    """ServingModel rebuilds the model from the exported JSON config — a
    pre-LN export must come back pre-LN (ln_final restored and used), not
    silently default to post-LN with a dropped param."""
    import dataclasses

    ds, vocab, cfg, _ = _setup("tied_softmax")
    cfg = dataclasses.replace(cfg, norm_style="pre")
    model = ClickstreamModel(cfg)
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir)
    assert served.config.norm_style == "pre"
    assert "ln_final" in served.params["params"]["encoder"]
    recs = served.recommend([["item_0", "item_1"]], k=5)
    assert len(recs[0]) == 5
    # the served scores come from the SAME function: log-probs within fp
    # noise of scoring through the pre-LN model directly
    scores = dict(recs[0])
    alt = ServingModel(export_dir)  # fresh load, same answer
    assert dict(alt.recommend([["item_0", "item_1"]], k=5)[0]) == scores


def test_chunked_eval_step_matches_dense():
    ds, vocab, cfg, model = _setup("tied_softmax")
    b = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b["features"], b["head_positions"])
    from bert4clickpath.training.train_state import make_eval_step as mes

    dense = mes(model)(params, b)
    chunked = mes(model, chunked_num_valid=vocab.label_vocab_size)(params, b)
    for k in ("n", "recall@10_sum", "ndcg@10_sum"):
        np.testing.assert_allclose(
            float(chunked[k]), float(dense[k]), rtol=1e-5, err_msg=k
        )
    np.testing.assert_allclose(
        float(chunked["loss_sum"]), float(dense["loss_sum"]), rtol=1e-4
    )


def test_scanned_eval_matches_per_batch():
    """make_eval_step(steps_per_call=K) over stacked chunks (ragged tail
    included) == per-batch eval merged: stats are sums, so scanning only
    changes dispatch count, never the numbers."""
    from bert4clickpath.data.cloze import stack_batches
    from bert4clickpath.training.train_state import make_eval_step as mes

    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    host = []
    for i, b in enumerate(ds.eval_batches(8)):
        host.append(b)
        if i == 4:
            break
    assert len(host) == 5

    single = mes(model, chunked_num_valid=vocab.label_vocab_size)
    want = None
    for b in host:
        s = {k: np.asarray(v) for k, v in single(params, _to_device(b)).items()}
        want = s if want is None else {k: want[k] + v for k, v in s.items()}

    scanned = mes(model, chunked_num_valid=vocab.label_vocab_size, steps_per_call=3)
    got = None
    for chunk in (host[:3], host[3:]):  # full chunk + ragged tail of 2
        s = scanned(params, _to_device(stack_batches(chunk)))
        s = {k: np.asarray(v) for k, v in s.items()}
        got = s if got is None else {k: got[k] + v for k, v in s.items()}

    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_serving_warmup_precompiles_buckets(tmp_path):
    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir, warmup_batches=(3, 8), warmup_k=5)
    # buckets 4 and 8 (and k=5) are compiled at load: a request inside a
    # warmed bucket triggers no new trace
    n_before = served._topk._cache_size()
    recs = served.recommend([["item_0"], ["item_1"], ["item_2"]], k=5)
    assert len(recs) == 3 and len(recs[0]) == 5
    assert served._topk._cache_size() == n_before


def test_serving_instance_id_passthrough(tmp_path):
    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir)
    out = served.recommend(
        [["item_0"], ["item_1"]], k=3, instance_ids=["req-a", "req-b"]
    )
    assert out[0]["instance_id"] == "req-a" and len(out[0]["items"]) == 3
    assert out[1]["instance_id"] == "req-b"


def test_trainer_eval_every(tmp_path):
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(
        batch_size=16,
        steps_per_epoch=2,
        n_epochs=5,
        eval_every=2,
        early_stopping_patience=10,
    )
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), donate=False),
        make_eval_step(model),
        tcfg,
        model_dir=str(tmp_path),
        to_device=_to_device,
    )
    trainer.fit(
        state,
        ds.train_batches(16, seed=1),
        lambda: ds.eval_batches(16, limit_batches=1),
        jax.random.PRNGKey(2),
    )
    evaluated = [r["epoch"] for r in trainer.history if "val_loss" in r]
    skipped = [r["epoch"] for r in trainer.history if "val_loss" not in r]
    # epochs 0, 2 by cadence; 4 is both cadence and the final epoch
    assert evaluated == [0, 2, 4]
    assert skipped == [1, 3]
    # skipped epochs still log training scalars
    for r in trainer.history:
        assert "train_loss" in r


def test_warmup_constant_schedule():
    s = schedules.warmup_constant(1e-3, warmup_steps=100)
    assert float(s(jnp.asarray(0))) == pytest.approx(0.0)
    assert float(s(jnp.asarray(50))) == pytest.approx(5e-4)
    assert float(s(jnp.asarray(100))) == pytest.approx(1e-3)
    assert float(s(jnp.asarray(100_000))) == pytest.approx(1e-3)


def test_auto_monitor_resolution():
    """TrainConfig's default monitor='auto' picks val_ndcg@10 for ranking
    heads and falls back to val_loss for heads without ranking metrics
    (binary), instead of the reference's always-val_loss trap."""
    # ranking head: best checkpoint follows NDCG (max), not val_loss
    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(batch_size=16, steps_per_epoch=2, n_epochs=2)
    assert tcfg.monitor == "auto"
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), donate=False),
        make_eval_step(model),
        tcfg,
        to_device=_to_device,
    )
    trainer.fit(
        TrainState.create(params, tx),
        ds.train_batches(16, seed=1),
        lambda: ds.eval_batches(16, limit_batches=1),
        jax.random.PRNGKey(2),
    )
    assert "val_ndcg@10" in trainer.history[0]

    # binary head: no ranking metrics in the record -> auto falls back to
    # val_loss without KeyError
    ds, vocab, cfg, model = _setup(head_kind="binary")
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    b0["labels"] = jnp.where(
        b0["labels"] >= 0, (b0["labels"] % 2).astype(jnp.float32), -1.0
    )

    def bin_batches():
        while True:
            yield b0

    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), donate=False),
        make_eval_step(model),
        tcfg,
        to_device=lambda b: b,
    )
    trainer.fit(
        TrainState.create(params, tx),
        bin_batches(),
        lambda: iter([b0]),
        jax.random.PRNGKey(2),
    )
    assert "val_ndcg@10" not in trainer.history[0]
    assert "val_loss" in trainer.history[0]


def test_serving_chunked_scores_match_dense(tmp_path):
    """Serving's chunked top-k (no (B, P, V) logits) must reproduce the
    dense log-softmax top-k exactly — tied and MLP (parity) heads."""
    for head_kind in ("tied_softmax", "softmax"):
        ds, vocab, cfg, model = _setup(head_kind)
        b0 = _to_device(next(ds.train_batches(8, seed=0)))
        params = model.init(
            {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
        )
        export_dir = ckpt_lib.export_serving(
            str(tmp_path / f"export_{head_kind}"),
            jax.device_get(params), cfg, {"items": vocab},
        )
        served = ServingModel(export_dir)
        sessions = [["item_0", "item_1", "item_2"], ["item_5"]]
        recs = served.recommend(sessions, k=5)

        # dense reference: same token build, full logits, log_softmax top-k
        from bert4clickpath.data.cloze import ITEM_OFFSET, token_length
        from bert4clickpath.constants import CLS_ID, MASK_ID, PAD_ID, SEP_ID

        max_items = cfg.max_len - 3
        tokens = np.full((2, token_length(max_items)), PAD_ID, np.int32)
        tokens[:, 0], tokens[:, 1], tokens[:, -1] = CLS_ID, SEP_ID, SEP_ID
        pos = np.zeros((2, 1), np.int32)
        for i, session in enumerate(sessions):
            ids = vocab.encode_model(list(session))
            tokens[i, ITEM_OFFSET : ITEM_OFFSET + len(ids)] = ids
            tokens[i, ITEM_OFFSET + len(ids)] = MASK_ID
            pos[i, 0] = ITEM_OFFSET + len(ids)
        logits = model.apply(
            params, {"items": jnp.asarray(tokens)}, jnp.asarray(pos)
        )[:, 0]
        logits = logits[:, : vocab.label_vocab_size]
        logprobs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        want_scores, want_idx = jax.lax.top_k(logprobs, 5)
        for i in range(2):
            got_items = [n for n, _ in recs[i]]
            got_scores = [s for _, s in recs[i]]
            want_items = [
                vocab.decode_label(int(j)) for j in np.asarray(want_idx[i])
            ]
            assert got_items == want_items, head_kind
            np.testing.assert_allclose(
                got_scores, np.asarray(want_scores[i]), rtol=1e-5, atol=1e-6,
                err_msg=head_kind,
            )


def test_auto_monitor_rejects_pinned_mode():
    # monitor='auto' + pinned mode could invert best-model selection
    # (mode='min' while auto resolves to val_ndcg@10 tracks the WORST epoch)
    from bert4clickpath.config import TrainConfig

    with pytest.raises(ValueError):
        TrainConfig(monitor_mode="min")
    TrainConfig(monitor="val_loss", monitor_mode="min")  # pinned pair: fine
    TrainConfig(monitor="val_ndcg@10", monitor_mode="auto")  # resolves by name


def test_serving_pad_rows_never_ranked(tmp_path):
    """Serving pads the catalog to the chunk multiple with zero rows; an
    untrained model's real logits sit near 0 too, so any blinding slip
    would leak pad rows into a full-vocab top-k. Ask for every valid item
    and check the result is exactly the catalog, once each, normalized."""
    ds, vocab, cfg, model = _setup("tied_softmax", n_items=37)
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir)
    k = vocab.label_vocab_size
    recs = served.recommend([["item_3", "item_7"]], k=k)[0]
    names = [n for n, _ in recs]
    assert len(set(names)) == k  # every valid item exactly once, no pads
    assert all(n.startswith("item_") for n in names), names[:5]
    total = float(np.exp([s for _, s in recs]).sum())
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)  # softmax over catalog only


def test_serving_multivariable_matches_dense(tmp_path):
    """(event, item) paired-feature serving: dict sessions, [MASK] on the
    item feature + [NA] on the event feature at the appended slot, exact
    match vs the dense log-softmax top-k."""
    from bert4clickpath.constants import (
        CLS_ID,
        MASK_ID,
        NA_ID,
        PAD_ID,
        SEP_ID,
    )
    from bert4clickpath.data.cloze import ITEM_OFFSET, token_length
    from bert4clickpath.vocab import Vocabulary

    item_vocab = Vocabulary([f"item_{i}" for i in range(25)])
    event_vocab = Vocabulary(["view", "click", "buy"])
    cfg = ModelConfig(
        features={
            "items": FeatureConfig(item_vocab.model_vocab_size, 16),
            "events": FeatureConfig(event_vocab.model_vocab_size, 8),
        },
        num_layers=1,
        num_heads=1,
        ffn_dim=32,
        max_len=13,
        head=HeadConfig("tied_softmax", output_size=item_vocab.label_vocab_size),
    )
    model = ClickstreamModel(cfg)
    L = cfg.max_len
    params = model.init(
        {"params": jax.random.PRNGKey(3)},
        {"items": jnp.zeros((1, L), jnp.int32), "events": jnp.zeros((1, L), jnp.int32)},
        jnp.zeros((1, 1), jnp.int32),
    )
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"),
        jax.device_get(params),
        cfg,
        {"items": item_vocab, "events": event_vocab},
    )
    served = ServingModel(export_dir)

    sessions = [
        {"items": ["item_1", "item_2"], "events": ["view", "buy"]},
        {"items": ["item_9"], "events": ["click"]},
    ]
    recs = served.recommend(sessions, k=4)

    # manual dense reference
    max_items = cfg.max_len - 3
    ti = np.full((2, token_length(max_items)), PAD_ID, np.int32)
    te = np.full((2, token_length(max_items)), PAD_ID, np.int32)
    for t in (ti, te):
        t[:, 0], t[:, 1], t[:, -1] = CLS_ID, SEP_ID, SEP_ID
    pos = np.zeros((2, 1), np.int32)
    for i, s in enumerate(sessions):
        ii = item_vocab.encode_model(s["items"])
        ee = event_vocab.encode_model(s["events"])
        n = len(ii)
        ti[i, ITEM_OFFSET : ITEM_OFFSET + n] = ii
        te[i, ITEM_OFFSET : ITEM_OFFSET + n] = ee
        ti[i, ITEM_OFFSET + n] = MASK_ID
        te[i, ITEM_OFFSET + n] = NA_ID
        pos[i, 0] = ITEM_OFFSET + n
    logits = model.apply(
        params,
        {"items": jnp.asarray(ti), "events": jnp.asarray(te)},
        jnp.asarray(pos),
    )[:, 0][:, : item_vocab.label_vocab_size]
    logprobs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    want_scores, want_idx = jax.lax.top_k(logprobs, 4)
    for i in range(2):
        got = [n for n, _ in recs[i]]
        want = [item_vocab.decode_label(int(j)) for j in np.asarray(want_idx[i])]
        assert got == want
        np.testing.assert_allclose(
            [s for _, s in recs[i]], np.asarray(want_scores[i]), rtol=1e-5
        )

    # a flat session list on a multi-feature model is a usage error
    with pytest.raises(ValueError):
        served.recommend([["item_1"]], k=2)
    # misaligned per-feature lengths too
    with pytest.raises(ValueError):
        served.recommend(
            [{"items": ["item_1", "item_2"], "events": ["view"]}], k=2
        )


def test_scan_train_step_matches_sequential():
    """K scanned steps in one dispatch == K sequential single steps:
    same per-step losses, same final params (identical math, only the
    host interaction changes)."""
    from bert4clickpath.data.cloze import stack_batches
    from bert4clickpath.training.train_state import make_scan_train_step

    ds, vocab, cfg, model = _setup()
    it = ds.train_batches(16, seed=0)
    host_batches = [next(it) for _ in range(4)]
    b0 = _to_device(host_batches[0])
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(TrainConfig())
    rng = jax.random.PRNGKey(1)

    step = make_train_step(model, tx, schedules.constant(1e-2), donate=False)
    seq_state = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    seq_losses = []
    for hb in host_batches:
        seq_state, loss = step(seq_state, _to_device(hb), rng)
        seq_losses.append(float(loss))

    scan_step = make_scan_train_step(model, tx, schedules.constant(1e-2))
    stacked = _to_device(stack_batches(host_batches))
    scan_state, losses = scan_step(TrainState.create(params, tx), stacked, rng)

    np.testing.assert_allclose(np.asarray(losses), seq_losses, rtol=1e-6)
    assert int(np.asarray(scan_state.step)) == 4
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
        ),
        jax.device_get(scan_state.params),
        jax.device_get(seq_state.params),
    )


def test_trainer_steps_per_call(tmp_path):
    """Trainer chunked mode: same epochs/records, train_loss is the mean
    over all K*chunks steps; config errors rejected."""
    from bert4clickpath.data.cloze import stack_batches
    from bert4clickpath.training.train_state import make_scan_train_step

    ds, vocab, cfg, model = _setup()
    tcfg = TrainConfig(batch_size=16, steps_per_epoch=4, n_epochs=2)
    b0 = _to_device(next(ds.train_batches(16, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    trainer = Trainer(
        make_scan_train_step(model, tx, schedules.constant(1e-3)),
        make_eval_step(model),
        tcfg,
        model_dir=str(tmp_path),
        to_device=_to_device,
        steps_per_call=2,
        stack_batches=stack_batches,
    )
    state = trainer.fit(
        TrainState.create(params, tx),
        ds.train_batches(16, seed=1),
        lambda: ds.eval_batches(16, limit_batches=1),
        jax.random.PRNGKey(2),
    )
    assert len(trainer.history) == 2
    assert int(np.asarray(state.step)) == 8  # 2 epochs x 4 steps
    assert np.isfinite(trainer.history[0]["train_loss"])

    with pytest.raises(ValueError):  # 4 % 3 != 0
        Trainer(
            lambda *a: None, lambda *a: None, tcfg,
            steps_per_call=3, stack_batches=stack_batches,
        )
    with pytest.raises(ValueError):  # missing stack_batches
        Trainer(lambda *a: None, lambda *a: None, tcfg, steps_per_call=2)


def test_serving_batch_bucketing(tmp_path):
    """Odd request sizes pad to a power-of-two bucket (shape reuse across
    requests); padded rows never leak into results and scores match the
    per-session results exactly."""
    ds, vocab, cfg, model = _setup("tied_softmax")
    b0 = _to_device(next(ds.train_batches(8, seed=0)))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg, {"items": vocab}
    )
    served = ServingModel(export_dir)
    sessions = [["item_0"], ["item_1", "item_2"], ["item_3"]]  # b=3 -> bucket 4
    recs = served.recommend(sessions, k=5)
    assert len(recs) == 3
    for i, s in enumerate(sessions):
        single = served.recommend([s], k=5)[0]
        assert [n for n, _ in single] == [n for n, _ in recs[i]]
        np.testing.assert_allclose(
            [v for _, v in single], [v for _, v in recs[i]], rtol=1e-5
        )


def test_serving_warmup_multivariable(tmp_path):
    """Warm-up must use dict-shaped empty sessions on multi-feature models
    (code-review round 4: list-shaped warm-up crashed the constructor)."""
    from bert4clickpath.data.generator import ClickStreamGenerator

    gen = ClickStreamGenerator(n_items=30, seed=0)
    vocab = gen.item_vocab()
    actions = Vocabulary(["view", "buy"])
    cfg = ModelConfig(
        features={
            "actions": FeatureConfig(actions.model_vocab_size, 8),
            "items": FeatureConfig(vocab.model_vocab_size, 24),
        },
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=13,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
    )
    model = ClickstreamModel(cfg)
    feats = {
        "actions": jnp.zeros((2, 13), jnp.int32),
        "items": jnp.zeros((2, 13), jnp.int32),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, feats, jnp.zeros((2, 1), jnp.int32)
    )
    export_dir = ckpt_lib.export_serving(
        str(tmp_path / "export"), jax.device_get(params), cfg,
        {"actions": actions, "items": vocab},
    )
    served = ServingModel(export_dir, warmup_batches=(2,), warmup_k=(3, 5))
    out = served.recommend(
        [{"actions": ["view"], "items": ["item_1"]}], k=3
    )
    assert len(out) == 1 and len(out[0]) == 3

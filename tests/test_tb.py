"""The minimal event writer must produce files the real TensorBoard reader
parses (tags, steps, values, CRCs) — validated against the installed
`tensorboard` package, which is a test-only dependency."""

import numpy as np
import pytest

from bert4clickpath.utils.tb import EventWriter


def _read_events(path):
    tb = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    loader = tb.LegacyEventFileLoader(path)
    return list(loader.Load())


def test_event_file_readable_by_tensorboard(tmp_path):
    w = EventWriter(str(tmp_path))
    w.scalar("val_loss", 1.25, step=7)
    w.scalars({"recall@10": 0.5, "epoch_flag": True, "name": "skip"}, step=8)
    w.close()

    events = _read_events(w.path)
    # first record: file version
    assert events[0].file_version == "brain.Event:2"
    got = {}
    for ev in events[1:]:
        for v in ev.summary.value:
            got[(v.tag, ev.step)] = v.simple_value
    assert np.isclose(got[("val_loss", 7)], 1.25)
    assert np.isclose(got[("recall@10", 8)], 0.5)
    assert np.isclose(got[("epoch_flag", 8)], 1.0)  # bools become floats
    assert not any(tag == "name" for tag, _ in got)  # strings skipped


def test_trainer_writes_events_and_async_best_save(tmp_path):
    """Trainer epoch records land in the event file; the async best-epoch
    checkpoint is committed (drained at fit end) and restorable."""
    import jax
    import jax.numpy as jnp

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
    from bert4clickpath.training.train_state import (
        TrainState,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from bert4clickpath.training.trainer import Trainer

    gen = ClickStreamGenerator(n_items=30, session_cohesiveness=100, seed=0)
    seqs, _ = gen.generate_sessions(120)
    vocab = gen.item_vocab()
    ds = ClozeDataset(seqs, vocab, max_items=12)
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 8)},
        num_layers=1,
        num_heads=1,
        ffn_dim=16,
        max_len=15,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
    )
    model = ClickstreamModel(cfg)
    tcfg = TrainConfig(
        batch_size=16, n_epochs=2, steps_per_epoch=3, early_stopping_patience=10
    )

    def to_device(b):
        return {
            "features": {k: jnp.asarray(v) for k, v in b.features.items()},
            "head_positions": jnp.asarray(b.head_positions),
            "labels": jnp.asarray(b.labels),
        }

    it = ds.train_batches(16, seed=0)
    b0 = to_device(next(it))
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"]
    )
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    schedule = schedules.constant(1e-2)
    trainer = Trainer(
        make_train_step(model, tx, schedule),
        make_eval_step(model),
        tcfg,
        model_dir=str(tmp_path),
        to_device=to_device,
        lr_fn=schedule,
    )
    state = trainer.fit(
        state,
        it,
        lambda: ds.eval_batches(16, limit_batches=2),
        jax.random.PRNGKey(1),
    )

    # TB events exist and contain the lr + val_loss tags
    import glob

    files = glob.glob(str(tmp_path / "tensorboard" / "events.out.tfevents.*"))
    assert files
    events = _read_events(files[0])
    tags = {v.tag for ev in events[1:] for v in ev.summary.value}
    assert {"train_loss", "val_loss", "lr"} <= tags

    # async best save committed and restorable
    latest = ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts"))
    assert latest is not None
    restored = ckpt_lib.restore_state(latest, jax.device_get(state))
    assert int(np.asarray(restored.step)) >= 1

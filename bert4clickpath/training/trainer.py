"""Training loop with the reference's callback semantics.

Replaces Keras ``model.fit`` + callbacks (reference source/main.py:123-167):

* epochs of ``steps_per_epoch`` jitted train steps;
* a validation pass per epoch (val_loss + ranking metrics);
* ReduceLROnPlateau(patience=10, factor=0.317) — via the state's
  ``lr_scale`` field (no retrace);
* EarlyStopping(patience=30) on val_loss;
* best-checkpoint save (async — the disk write overlaps the next epoch,
  fit() waits at the end) + best serving export;
* metric history as JSONL plus TensorBoard event files under
  ``model_dir/tensorboard`` (reference source/main.py:144-149) including
  the effective LR (LRTensorBoard, training_utils.py:77-84).

Host-0-only side effects; metric sums are exact global values by
construction (losses/metrics psum when ``axis_name`` is set).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Iterator, Optional

import jax
import numpy as np

from bert4clickpath.config import TrainConfig
from bert4clickpath.ops import metrics as metrics_lib
from bert4clickpath.training import checkpoint as ckpt_lib
from bert4clickpath.training.train_state import TrainState, eval_params


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        eval_step: Callable,
        cfg: TrainConfig,
        model_dir: Optional[str] = None,
        to_device: Callable = lambda b: b,
        export_fn: Optional[Callable] = None,
        is_host0: bool = True,
        lr_fn: Optional[Callable] = None,
        tensorboard: bool = True,
        prefetch: int = 2,
        steps_per_call: int = 1,
        stack_batches: Optional[Callable] = None,
        eval_steps_per_call: int = 1,
    ):
        """
        train_step: (state, batch, rng) -> (state, loss)

        steps_per_call > 1 runs that many train steps per device call:
        ``train_step`` must then be a scan step
        (train_state.make_scan_train_step) returning (K,) losses, and
        ``stack_batches`` must stack K host batches into one with a leading
        K axis (e.g. data.cloze.stack_batches). One dispatch + one transfer
        per K steps, so the host's per-step dispatch cost is paid once per
        K steps. steps_per_epoch must be a
        multiple of steps_per_call (a ragged tail chunk would recompile).
        eval_step: (params, batch) -> stats dict of sums
        eval_steps_per_call > 1 feeds ``eval_step`` STACKED (K, B, ...)
        chunks (``eval_step`` must then be a scanned step,
        make_eval_step(steps_per_call=K)); the last chunk of a pass may be
        smaller, costing one extra compile that is cached across epochs.
        to_device: ClozeBatch -> the batch dict the steps expect (handles
            device_put / sharding in the pjit case)
        export_fn: params -> None, called when val_loss improves
        lr_fn: step -> base LR (the schedule); logged as ``lr`` scaled by
            the plateau ``lr_scale`` (reference LRTensorBoard parity)
        tensorboard: also write TB event files under model_dir/tensorboard
        prefetch: keep this many batches already transferred to device so
            host->device copies overlap the running step (the reference's
            tf.data ``prefetch(AUTOTUNE)``, input_pipeline.py:229); 0 to
            transfer synchronously inside the step loop
        """
        self.train_step = train_step
        self.eval_step = eval_step
        self.cfg = cfg
        self.model_dir = model_dir
        self.to_device = to_device
        self.export_fn = export_fn
        self.is_host0 = is_host0
        self.lr_fn = lr_fn
        self.prefetch = prefetch
        self.steps_per_call = max(1, steps_per_call)
        self.stack_batches = stack_batches
        self.eval_steps_per_call = max(1, eval_steps_per_call)
        if self.eval_steps_per_call > 1 and stack_batches is None:
            raise ValueError("eval_steps_per_call > 1 requires stack_batches")
        if self.steps_per_call > 1:
            if stack_batches is None:
                raise ValueError("steps_per_call > 1 requires stack_batches")
            if cfg.steps_per_epoch % self.steps_per_call:
                raise ValueError(
                    f"steps_per_epoch {cfg.steps_per_epoch} not a multiple "
                    f"of steps_per_call {self.steps_per_call}"
                )
        self.history: list[dict] = []
        self._merge_jit = jax.jit(metrics_lib.merge)
        self._tb = None
        if tensorboard and model_dir and is_host0:
            from bert4clickpath.utils.tb import EventWriter

            self._tb = EventWriter(os.path.join(model_dir, "tensorboard"))

    # -- logging ----------------------------------------------------------
    def _log(self, record: dict):
        self.history.append(record)
        if not self.is_host0:
            return
        msg = " ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
        )
        print(msg, flush=True)
        if self.model_dir:
            os.makedirs(self.model_dir, exist_ok=True)
            with open(os.path.join(self.model_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            scalars = {k: v for k, v in record.items() if k not in ("epoch", "step")}
            self._tb.scalars(scalars, record.get("step", len(self.history)))
            self._tb.flush()

    # -- evaluation -------------------------------------------------------
    def _stacked_chunks(self, batches: Iterator) -> Iterator:
        """Group host batches into stacks of eval_steps_per_call (smaller
        final chunk included) for the scanned eval step."""
        buf = []
        for b in batches:
            buf.append(b)
            if len(buf) == self.eval_steps_per_call:
                yield self.stack_batches(buf)
                buf = []
        if buf:
            yield self.stack_batches(buf)

    def evaluate(self, params, eval_batches: Iterator) -> dict[str, float]:
        from bert4clickpath.data.pipeline import prefetch_to_device

        if self.eval_steps_per_call > 1:
            eval_batches = self._stacked_chunks(eval_batches)
        if self.prefetch:
            eval_batches = prefetch_to_device(
                eval_batches, self.to_device, depth=self.prefetch
            )
        else:
            eval_batches = (self.to_device(b) for b in eval_batches)
        # Accumulate ON DEVICE and fetch once: a per-batch np.asarray is a
        # host round-trip that stalls the dispatch queue, and a full-catalog
        # pass is hundreds of batches.
        acc = None
        for batch in eval_batches:
            stats = self.eval_step(params, batch)
            acc = stats if acc is None else self._merge_jit(acc, stats)
        if acc is None:
            return {"n": 0.0, "loss": float("nan")}
        return metrics_lib.finalize(jax.device_get(acc))

    # -- fit --------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        train_batches: Iterator,
        eval_batches_fn: Callable[[], Iterator],
        rng,
        n_epochs: Optional[int] = None,
    ) -> TrainState:
        from bert4clickpath.data.pipeline import prefetch_to_device

        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        monitor = cfg.monitor
        if cfg.monitor_mode == "auto":
            sign = None  # resolved with the monitor at the first eval
        else:
            sign = 1.0 if cfg.monitor_mode == "min" else -1.0
        best_val = math.inf
        epochs_since_best = 0
        epochs_since_plateau_cut = 0
        spc = self.steps_per_call
        if spc > 1:
            # stack K host batches -> one (K, ...) chunk -> one transfer;
            # the scan step runs all K on device in one dispatch
            host_iter = train_batches

            def chunks():
                while True:
                    yield self.stack_batches(
                        [next(host_iter) for _ in range(spc)]
                    )

            train_batches = chunks()
        if self.prefetch:
            train_batches = prefetch_to_device(
                train_batches, self.to_device, depth=self.prefetch
            )
        else:
            train_batches = (self.to_device(b) for b in train_batches)

        import jax.numpy as jnp

        eval_every = max(1, getattr(cfg, "eval_every", 1))
        for epoch in range(n_epochs):
            t0 = time.monotonic()
            losses = []
            for _ in range(cfg.steps_per_epoch // spc):
                batch = next(train_batches)
                state, loss = self.train_step(state, batch, rng)
                losses.append(jnp.atleast_1d(loss))
            # one fused fetch — per-scalar np.asarray would be a host
            # round-trip per step
            step_losses = np.asarray(jnp.concatenate(losses))
            train_loss = float(step_losses.mean())
            dt = time.monotonic() - t0

            do_eval = (epoch % eval_every == 0) or (epoch == n_epochs - 1)
            record = {
                "epoch": epoch,
                "step": int(np.asarray(state.step)),
                "train_loss": train_loss,
                "train_loss_first": float(step_losses[0]),
                "train_loss_last": float(step_losses[-1]),
                "epoch_seconds": round(dt, 3),
                "lr_scale": float(np.asarray(state.lr_scale)),
            }
            if self.lr_fn is not None:
                record["lr"] = float(
                    np.asarray(self.lr_fn(record["step"]))
                ) * record["lr_scale"]
            if not do_eval:
                self._log(record)
                continue
            # EMA-enabled states validate and export the shadow params
            t_eval = time.monotonic()
            val = self.evaluate(eval_params(state), eval_batches_fn())
            record["eval_seconds"] = round(time.monotonic() - t_eval, 3)
            record["val_loss"] = float(val.get("loss", float("nan")))
            for k, v in val.items():
                if k not in ("loss", "n"):
                    record[f"val_{k}"] = float(v)
            self._log(record)

            if monitor == "auto":
                # the repo's own finding (BASELINE.md): full-softmax val_loss
                # diverges while ranking still improves, so monitoring it
                # early-stops ranking runs at ~half their reachable recall —
                # prefer the ranking metric whenever the head emits one
                monitor = "val_ndcg@10" if "val_ndcg@10" in record else "val_loss"
            if sign is None:  # monitor_mode == "auto": losses fall, metrics rise
                sign = 1.0 if "loss" in monitor else -1.0
            if monitor not in record:
                raise KeyError(
                    f"monitor {monitor!r} not in epoch record "
                    f"(available: {sorted(record)})"
                )
            monitored = sign * record[monitor]
            if monitored < best_val:
                best_val = monitored
                epochs_since_best = 0
                epochs_since_plateau_cut = 0
                if self.model_dir and self.is_host0:
                    # async: the write overlaps the next epoch's compute;
                    # the next save (one write in flight at a time) and
                    # fit()'s end wait for it
                    ckpt_lib.save_checkpoint(
                        os.path.join(self.model_dir, "ckpts"),
                        jax.device_get(state),
                        int(np.asarray(state.step)),
                        block=False,
                        keep=cfg.ckpt_keep,
                    )
                if self.export_fn is not None and self.is_host0:
                    self.export_fn(jax.device_get(eval_params(state)))
            else:
                epochs_since_best += 1
                epochs_since_plateau_cut += 1
                # ReduceLROnPlateau (reference source/main.py:134)
                if epochs_since_plateau_cut >= cfg.plateau_patience:
                    state = state.replace(
                        lr_scale=state.lr_scale * cfg.plateau_factor
                    )
                    epochs_since_plateau_cut = 0
                # EarlyStopping (reference source/main.py:156)
                if epochs_since_best >= cfg.early_stopping_patience:
                    self._log({"epoch": epoch, "early_stop": True})
                    break
        if self.model_dir and self.is_host0:
            ckpt_lib.wait_until_finished()  # drain any in-flight async save
        if self._tb is not None:
            self._tb.close()
        return state

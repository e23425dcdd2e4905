"""Training orchestration: the host loop around the train step.

Counterpart of ``pretraining_llm_tpu/training/trainer.py`` on one device:
fresh init or resume from the latest loadable checkpoint (params, AdamW
moments, step and data-sampler RNG, so a resumed run reproduces the
uninterrupted one), a deterministic eval set per ``evaluate()``, periodic
atomic checkpoints, a final save, and JSONL/stdout metrics with step ms,
tokens/s and MFU over log windows that exclude eval and save time. The loop
does no math; metrics reach the host only at log boundaries.

Options, as in the JAX trainer: ``data.prefetch`` > 0 samples and copies
batches that many steps ahead on a thread (``data.loader.DevicePrefetcher``:
pinned host memory, a side CUDA stream and an event the step's stream waits
on), checkpointing the consumed-batch RNG frontier; ``train.
checkpoint_async`` copies the state to host memory at the step and writes
it on a thread, joined (and its error raised) on every exit path;
``train.profile_dir`` traces steps [profile_start, profile_start +
profile_steps) (``utils.profiling.StepProfiler``); ``train.debug_nans``
makes a step raise ``FloatingPointError`` at a non-finite loss or gradient
(``utils.debug``); mixture specs in ``data.train_path``.

Not ported (listed in ROADMAP): the step watchdog, the preemption handler,
anomaly detection and rollback, fault injection, the observability hub,
meshes and multi-process runs, and the native batcher.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.data import loader as data_loader
from pretraining_llm_tpu_torch.models import transformer
from pretraining_llm_tpu_torch.training import checkpoint as ckpt
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.training import train_step as ts
from pretraining_llm_tpu_torch.training.metrics import MetricsLogger, Throughput
from pretraining_llm_tpu_torch.utils import debug
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device
from pretraining_llm_tpu_torch.utils.profiling import StepProfiler

HostBatch = Tuple[np.ndarray, np.ndarray]
EVAL_SEED_OFFSET = 104729  # eval batches are drawn with data.sample_seed + this, never advanced


class Trainer:
    def __init__(
        self,
        config: Config,
        *,
        train_iterator: Optional[Iterator[HostBatch]] = None,
        val_iterator: Optional[Iterator[HostBatch]] = None,
        synthetic_data: bool = False,
        resume: bool = True,
        logger: Optional[MetricsLogger] = None,
        device: DeviceLike = None,
    ) -> None:
        self.config = config
        if config.train.debug_nans:
            debug.enable_nan_checks()
        self.device = resolve_device(device)
        self._owns_logger = logger is None
        self.logger = logger or MetricsLogger(config.train.metrics_path)
        self.step_fn = ts.build_train_step(config)
        self.eval_loop = ts.build_eval_loop(config)
        self.throughput = Throughput(config.model, self.device)
        self._synthetic_data = synthetic_data
        mcfg, dcfg, tcfg = config.model, config.data, config.train
        if train_iterator is None:
            if synthetic_data:
                train_iterator = data_loader.synthetic_iterator(
                    mcfg.vocab_size, mcfg.context_length, tcfg.batch_size, dcfg.sample_seed)
            else:
                train_iterator = data_loader.get_batch_iterator(
                    dcfg.train_path, tcfg.batch_size, mcfg.context_length, seed=dcfg.sample_seed)
        self.train_iterator = train_iterator
        # None = a fresh deterministic eval set per evaluate(); an injected
        # iterator is consumed as a stream instead.
        self.val_iterator = val_iterator
        self._eval_batch_cache: Dict[int, HostBatch] = {}
        self._feed: Optional[data_loader.DevicePrefetcher] = None
        self._writer = ckpt.AsyncCheckpointWriter()
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        self.start_step = 0
        restored = None
        if resume and ckpt.latest_checkpoint(tcfg.checkpoint_dir) is not None:
            restored = ckpt.restore_latest(
                tcfg.checkpoint_dir, self._state_template(),
                on_skip=lambda path, e: self.logger.log(
                    {"event": "checkpoint_skipped", "path": path, "error": repr(e)[:200]}),
            )
            if restored is None:
                raise RuntimeError(
                    f"checkpoint dir {tcfg.checkpoint_dir!r} contains step dirs but none "
                    "are loadable; refusing to reinitialize over a corrupt lineage (pass "
                    "resume=False to override)"
                )
        if restored is not None:
            state, extra, restored_step = restored
            self.state = opt.tree_map(lambda x: x.to(self.device), state)
            rng_state = extra.get("data_rng")
            if rng_state is not None and hasattr(self.train_iterator, "set_state"):
                self.train_iterator.set_state(rng_state)
            self.start_step = int(extra.get("step", 0))
            self.logger.log({
                "event": "resumed", "from": os.path.join(tcfg.checkpoint_dir, f"step-{restored_step}"),
                "step": self.start_step,
            })
        else:
            self.state = ts.init_train_state(config, tcfg.seed, device=self.device)

    def _state_template(self) -> Dict[str, Any]:
        """The train state's tree as meta tensors: shapes for a checkpoint
        template, nothing allocated."""
        def meta(tree: Dict[str, Any]) -> Dict[str, Any]:
            return {k: meta(v) if isinstance(v, dict) else torch.empty(v, device="meta")
                    for k, v in tree.items()}

        params = meta(transformer.param_shapes(self.config.model))
        scalar = torch.empty((), device="meta")
        state: Dict[str, Any] = {
            "params": params, "opt": opt.optimizer_init(params, self.config.train), "step": scalar,
        }
        if self.config.train.ema_decay > 0:
            state["ema"] = params
        return state

    def _put(self, batch: HostBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host batch -> device tensors (pinned memory, non-blocking copy
        on a card)."""
        def one(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t
        return one(batch[0]), one(batch[1])

    def _put_ahead(self, batch: HostBatch) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Any]:
        """The prefetcher's put, on its thread: on a card, the pinned copy
        runs on a side stream and ``ready`` makes the consumer's stream wait
        for it; on the CPU, ``_put``."""
        if self._copy_stream is None:
            return self._put(batch), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            x, y = self._put(batch)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)

        def ready() -> None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            x.record_stream(stream)
            y.record_stream(stream)

        return (x, y), ready

    def _close_feed(self) -> None:
        """Stop the prefetch thread and rewind the source to the consumed
        frontier, so a later ``train`` call draws the discarded batches
        again (a worker that does not stop keeps its stream: no rewind)."""
        if self._feed is None:
            return
        frontier = self._feed.state()
        if self._feed.close() and frontier is not None and hasattr(self.train_iterator, "set_state"):
            self.train_iterator.set_state(frontier)
        self._feed = None

    def _fresh_val_iterator(self) -> Iterator[HostBatch]:
        """A new iterator per evaluate(): the same eval batches every time."""
        mcfg, dcfg, tcfg = self.config.model, self.config.data, self.config.train
        eval_seed = dcfg.sample_seed + EVAL_SEED_OFFSET
        if self._synthetic_data:
            return data_loader.synthetic_iterator(
                mcfg.vocab_size, mcfg.context_length, tcfg.batch_size, eval_seed)
        return data_loader.get_batch_iterator(
            dcfg.val_path, tcfg.batch_size, mcfg.context_length, seed=eval_seed)

    def evaluate(self, iters: Optional[int] = None) -> float:
        """Mean val loss over ``iters`` fixed batches (cached per ``iters``;
        an injected val stream is read anew each call)."""
        iters = iters or self.config.train.eval_iters
        if self.val_iterator is not None:
            xs, ys = zip(*(next(self.val_iterator) for _ in range(iters)))
            batch = (np.stack(xs), np.stack(ys))
        else:
            batch = self._eval_batch_cache.get(iters)
            if batch is None:
                it = self._fresh_val_iterator()
                xs, ys = zip(*(next(it) for _ in range(iters)))
                batch = (np.stack(xs), np.stack(ys))
                self._eval_batch_cache[iters] = batch
        return float(self.eval_loop(self.state, self._put(batch)))

    def save(self, step: int, *, sync: bool = False) -> Optional[str]:
        """Write a checkpoint of this step. With ``train.checkpoint_async``
        (and not ``sync``), the state is copied to host memory here and
        written on a thread: returns None."""
        extra: Dict[str, Any] = {
            "step": step,
            "config": dataclasses.asdict(self.config),
            "preset": self.config.name,
            "block_layout": "depth_major",
        }
        local_extra: Dict[str, Any] = {}
        # With the prefetcher running, the source's RNG is ahead by the queue:
        # checkpoint the consumed-batch frontier.
        rng_src = self._feed if self._feed is not None else self.train_iterator
        if hasattr(rng_src, "state") and rng_src.state() is not None:
            local_extra["data_rng"] = rng_src.state()
        kwargs = dict(extra=extra, local_extra=local_extra, keep=self.config.train.keep_checkpoints)
        directory = self.config.train.checkpoint_dir
        if self.config.train.checkpoint_async and not sync:
            self._writer.save(directory, step, self.state, **kwargs)
            return None
        self.join_pending_save()  # never two writes into the directory at once
        return ckpt.save_checkpoint(directory, step, self.state, **kwargs)

    def join_pending_save(self) -> None:
        """Wait for an async checkpoint write in flight; raise
        ``RuntimeError`` from its error."""
        self._writer.join()

    def train(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Train until the state's step reaches ``steps`` (default
        ``train.train_steps``): a later call continues where the previous
        one stopped. Returns the last logged metrics."""
        tcfg = self.config.train
        total = steps if steps is not None else tcfg.train_steps
        tokens_per_step = tcfg.batch_size * self.config.model.context_length
        profiler = StepProfiler(tcfg.profile_dir, tcfg.profile_start, tcfg.profile_steps)
        last: Dict[str, float] = {}
        step = int(self.state["step"])
        try:
            while step < total:
                if self._feed is None and self.config.data.prefetch > 0:
                    self._feed = data_loader.DevicePrefetcher(
                        self.train_iterator, self._put_ahead, self.config.data.prefetch)
                profiler.step(step)
                if self._feed is not None:
                    batch = next(self._feed)
                else:
                    batch = self._put(next(self.train_iterator))
                self.state, metrics = self.step_fn(self.state, batch)
                self.throughput.tick(tokens_per_step)
                step += 1
                off_path = False
                if step % tcfg.log_interval == 0 or step == total:
                    last = {k: float(v) for k, v in metrics.items()}  # device sync
                    last.update(self.throughput.window())
                    self.logger.log({"step": step, **last})
                if tcfg.eval_interval > 0 and step % tcfg.eval_interval == 0:
                    val_loss = self.evaluate()
                    eval_metrics = {
                        "val_loss": val_loss,
                        "val_ppl": math.exp(val_loss) if val_loss < 700 else float("inf"),
                        "val_bits_per_token": val_loss / math.log(2.0),
                    }
                    last.update(eval_metrics)
                    self.logger.log({"step": step, **eval_metrics})
                    off_path = True
                if tcfg.checkpoint_interval > 0 and step % tcfg.checkpoint_interval == 0:
                    self.save(step)
                    off_path = True
                if off_path:
                    self.throughput.reset_clock()  # keep eval/save time out of step_ms
        except Exception as e:
            # Persist the last good state before propagating: the step
            # raises before its optimizer update (a NaN check, a kernel
            # error), so self.state is still the previous step's.
            self.logger.log({"event": "failure", "step": step, "error": repr(e)[:200]})
            try:
                self.save(step, sync=True)
            except Exception as save_err:  # keep the original error primary
                self.logger.log({"event": "emergency_save_failed", "error": repr(save_err)[:200]})
            raise
        finally:
            propagating = sys.exc_info()[0] is not None
            profiler.close()
            self._close_feed()
            try:
                self.join_pending_save()
            except RuntimeError:
                self.logger.log({"event": "async_checkpoint_failed", "step": step})
                if not propagating:
                    raise
            finally:
                if self._owns_logger:
                    self.logger.close()
        if tcfg.save_final and (tcfg.checkpoint_interval <= 0 or step % tcfg.checkpoint_interval != 0):
            self.save(step, sync=True)
        return last

"""Training orchestration: the host loop around the train step.

Counterpart of ``pretraining_llm_tpu/training/trainer.py`` on one device:
fresh init or resume from the latest loadable checkpoint (params, AdamW
moments, step and data-sampler state, so a resumed run reproduces the
uninterrupted one), a deterministic eval set per ``evaluate()``, periodic
atomic checkpoints, a final save, and JSONL/stdout metrics with step ms,
tokens/s and MFU over log windows that exclude eval and save time. The loop
does no math; metrics reach the host only at log boundaries.

Options, as in the JAX trainer: ``data.prefetch`` > 0 samples and copies
batches that many steps ahead on a thread (``data.loader.DevicePrefetcher``:
pinned host memory, a side CUDA stream and an event the step's stream waits
on), checkpointing the consumed-batch frontier; single token files are
sampled by the native counter-based gatherer (``data.use_native_batcher``,
``data/native_batcher.py``; mixtures, or a host without a C++ compiler,
take the numpy sampler, and the ``run_start`` event names the sampler);
``train.checkpoint_async`` copies the state to host memory at the step and
writes it on a thread, joined (and its error raised) on every exit path;
``train.profile_dir`` traces steps [profile_start, profile_start +
profile_steps) (``utils.profiling.StepProfiler``); ``train.debug_nans``
makes a step raise ``FloatingPointError`` at a non-finite loss or gradient
(``utils.debug``); mixture specs in ``data.train_path``.

Resilience (``resilience/``, the ``resilience`` section), all host-side:
SIGTERM asks for a checkpoint and a stop at the next log boundary
(``exit_reason`` "preempted"); the anomaly detector reads each log
boundary's metrics and ``RollbackManager`` restores the newest good
checkpoint and skips the poison window ("anomaly_budget",
"anomaly_no_checkpoint" when it cannot); fault drills fire before their
step; the step watchdog, armed by the first completed step and paused
around eval, saves and restores, exits EXIT_WEDGED after an emergency
checkpoint. The optimizer updates the state in place, so the emergency
checkpoint is taken only at a step boundary: after a step was enqueued
whole and before the next one's first write, with the copies enqueued on
the training stream (stream order gives that step's values); elsewhere it
is skipped (``emergency_save_skipped``) rather than written torn.
Observability (``observability/``, the ``obs`` section): run events,
spans around restore, save and eval, goodput in every log record, device
memory samples and build telemetry, through ``ObservabilityHub``.

Meshes (``parallel/``), as the JAX trainer runs them: the mesh comes from
``config.mesh`` (``needs_mesh``/``build_mesh``, one process per rank under
``torchrun``); the state is ``train_step.shard_train_state``'s blocks. Each
node (torchrun's group rank, JAX's process) draws its rows of the global
batch with the JAX trainer's per-process seed (``sample_seed + 7919 *
node``) and each rank keeps its data x fsdp block of them, every column (a
one-node run on N ranks reads the global batches of a one-process run);
``loss_fn`` takes the rank's seq share. Logging, run events and telemetry
are rank 0's; checkpoints are written by every rank (sharded leaves in
blocks) and restored onto any mesh; a SIGTERM on any rank stops every rank
at the same log boundary; ``checkpoint_async`` and the watchdog's
emergency checkpoint are single-process only, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.config import Config
from pretraining_llm_tpu_torch.data import loader as data_loader
from pretraining_llm_tpu_torch.observability.hub import ObservabilityHub
from pretraining_llm_tpu_torch.parallel import mesh as pmesh
from pretraining_llm_tpu_torch.training import checkpoint as ckpt
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.training import train_step as ts
from pretraining_llm_tpu_torch.training.metrics import MetricsLogger, Throughput
from pretraining_llm_tpu_torch.utils import debug
from pretraining_llm_tpu_torch.utils.device import DeviceLike, resolve_device
from pretraining_llm_tpu_torch.utils.profiling import StepProfiler

HostBatch = Tuple[np.ndarray, np.ndarray]
EVAL_SEED_OFFSET = 104729  # eval batches are drawn with data.sample_seed + this, never advanced


@contextlib.contextmanager
def _watchdog_paused(watchdog):
    """Disarm the step watchdog around off-path host work (eval, a save, a
    rollback restore): its timeout budgets a step."""
    if watchdog is None:
        yield
        return
    watchdog.pause()
    try:
        yield
    finally:
        watchdog.resume()


def sampler_name(iterator: Any) -> str:
    """What draws a trainer's batches: "native", "numpy", "synthetic" or
    "injected" (an iterator the caller passed)."""
    from pretraining_llm_tpu_torch.data.native_batcher import NativeBatchIterator

    if isinstance(iterator, NativeBatchIterator):
        return "native"
    if isinstance(iterator, data_loader.BatchIterator):
        return "synthetic" if isinstance(iterator.source, data_loader.SyntheticTokens) else "numpy"
    if isinstance(iterator, data_loader.MixtureIterator):
        return "numpy"
    return "injected"


class Trainer:
    # Upper bound on the watchdog's emergency checkpoint: a wedged device
    # blocks the device-to-host copy, and the watchdog must still exit.
    EMERGENCY_SAVE_TIMEOUT_S = 60.0
    _NOT_INSTALLED = object()  # the SIGTERM handler could not be installed

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
        mesh: Any = None,
    ) -> None:
        self.config = config
        if config.train.debug_nans:
            debug.enable_nan_checks()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None and pmesh.world_size() > 1:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if pmesh.backend() == "nccl" and self.device.type != "cuda":
            raise RuntimeError(
                f"the process group's backend (cuda collectives) does not match the device "
                f"{self.device}: NCCL drives the cards; run CPU ranks over gloo")
        self.mesh = mesh if mesh is not None else (
            pmesh.build_mesh(config.mesh, self.device.type) if pmesh.needs_mesh(config.mesh) else None)
        self.is_host0 = pmesh.rank() == 0
        self._owns_logger = logger is None
        if logger is None:
            logger = (MetricsLogger(config.train.metrics_path) if self.is_host0
                      else MetricsLogger("", stream=open(os.devnull, "w")))
        self.logger = logger
        # Run events, spans, goodput, device memory and build telemetry; the
        # file sinks are the obs section's, rank 0's.
        self.obs = ObservabilityHub(config.obs, is_host0=self.is_host0)
        self.step_fn = ts.build_train_step(config, self.mesh)
        self.eval_loop = ts.build_eval_loop(config, self.mesh)
        self.throughput = Throughput(config.model, self.device, pmesh.world_size())
        self._synthetic_data = synthetic_data
        mcfg, dcfg, tcfg = config.model, config.data, config.train
        self._rows = self._row_block()
        if train_iterator is None:
            if synthetic_data:
                train_iterator = data_loader.synthetic_iterator(
                    mcfg.vocab_size, mcfg.context_length, self._node_batch, self._node_seed(dcfg.sample_seed))
            else:
                train_iterator = self._make_iterator(dcfg.train_path, dcfg.sample_seed)
        self.train_iterator = train_iterator
        self.sampler = sampler_name(train_iterator)
        # None = a fresh deterministic eval set per evaluate(); an injected
        # iterator is consumed as a stream instead.
        self.val_iterator = val_iterator
        self._eval_batch_cache: Dict[int, HostBatch] = {}
        self._feed: Optional[data_loader.DevicePrefetcher] = None
        self._writer = ckpt.AsyncCheckpointWriter()
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        # Resume: tmp-<step> partials are collected and a corrupt newest
        # checkpoint falls back to the previous good one; step dirs of which
        # none loads refuse a fresh start (it would lose the lineage).
        self.start_step = 0
        restored = None
        restore_t0 = time.perf_counter()
        if resume and ckpt.latest_checkpoint(tcfg.checkpoint_dir) is not None:
            with self.obs.spans.span("ckpt_restore"):
                restored = ckpt.restore_latest(
                    tcfg.checkpoint_dir, self._state_template(), loader=self._checkpoint_loader,
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
            self.start_step = self._adopt_restored(state, extra)
            self.obs.bus.emit("ckpt_restore", step=self.start_step, dur_s=time.perf_counter() - restore_t0)
            self.logger.log({
                "event": "resumed", "from": os.path.join(tcfg.checkpoint_dir, f"step-{restored_step}"),
                "step": self.start_step,
            })
        else:
            self.state = ts.init_train_state(config, tcfg.seed, device=self.device, mesh=self.mesh)
        self._ckpt_layout = self._checkpoint_layout()
        # Set by the SIGTERM handler; the loop checkpoints and stops at the
        # next log boundary.
        self._stop_requested = False
        # Why the last train() ended: "completed" | "preempted" |
        # "anomaly_budget" | "anomaly_no_checkpoint" (``train.py`` maps it to
        # the return codes the supervisor reads).
        self.exit_reason = "completed"
        # The step boundary the emergency checkpoint may save at: True from
        # the moment a step is enqueued whole until the next step starts;
        # the lock orders the watchdog's copies before that step's writes.
        self._boundary = threading.Lock()
        self._at_boundary = True
        self._completed_step = self.start_step
        self._boundary_frontier: Any = None  # the data frontier of _completed_step
        self._train_stream: Optional[torch.cuda.Stream] = None
        self._profiler: Optional[StepProfiler] = None

    def _row_block(self) -> slice:
        """This rank's rows of its node's batch: the batch is cut into
        data x fsdp blocks in mesh order (``batch_pspec``); a node draws
        ``batch_size / nodes`` rows, and a rank's block must lie in its
        node's."""
        b = self.config.train.batch_size
        n_nodes = pmesh.node_count()
        if b % n_nodes:
            raise ValueError(f"batch_size={b} must divide by the number of nodes={n_nodes}")
        self._node_batch = b // n_nodes
        if self.mesh is None:
            return slice(0, self._node_batch)
        shape, coord = pmesh.mesh_shape(self.mesh), pmesh.coordinate(self.mesh)
        n = shape["data"] * shape["fsdp"]
        if b % n:
            raise ValueError(f"batch_size={b} must divide by data x fsdp={n}")
        rows = b // n
        lo = (coord["data"] * shape["fsdp"] + coord["fsdp"]) * rows - pmesh.node_index() * self._node_batch
        if not 0 <= lo <= self._node_batch - rows:
            raise ValueError("a rank's batch rows must lie within its node's rows")
        return slice(lo, lo + rows)

    def _node_seed(self, seed: int) -> int:
        """The JAX trainer's per-process seed, per node."""
        return seed + 7919 * pmesh.node_index()

    def _make_iterator(self, path: str, seed: int) -> Iterator[HostBatch]:
        """File batches: the native gatherer for a single file when
        ``data.use_native_batcher`` (and the library builds), else the numpy
        sampler (mixtures, no compiler), as the JAX trainer chooses. The
        node's rows only, sampled from the node's contiguous shard of the
        token stream (JAX's process shard: ``shard_index`` = the node,
        ``shard_count`` = the nodes)."""
        dcfg, mcfg = self.config.data, self.config.model
        batch = self._node_batch
        shard = dict(shard_index=pmesh.node_index(), shard_count=pmesh.node_count())
        if dcfg.use_native_batcher and not data_loader.is_mixture(path):
            from pretraining_llm_tpu_torch.data.native_batcher import NativeBatchIterator

            try:
                return NativeBatchIterator(path, batch, mcfg.context_length, seed=seed, **shard)
            except (RuntimeError, ValueError):
                pass  # no compiler, or a file it cannot map: the numpy sampler says why
        return data_loader.get_batch_iterator(path, batch, mcfg.context_length, seed=seed, **shard)

    def _checkpoint_layout(self) -> Optional[Dict[str, Any]]:
        """The sharded leaves' layout of this rank's checkpoint writes
        (``train_step.checkpoint_layout``; None without a mesh)."""
        if self.mesh is None:
            return None
        return ts.checkpoint_layout(self._state_template(), self.mesh, self.config)

    # --- restore / rollback plumbing ----------------------------------
    def _state_template(self) -> Dict[str, Any]:
        """The train state's tree as meta tensors (``train_step.
        state_template``)."""
        return ts.state_template(self.config)

    def _checkpoint_loader(self, path: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
        """``load_checkpoint`` with the JAX trainer's EMA fallback: a
        checkpoint written before ``ema_decay`` was turned on seeds the
        shadow from its params."""
        try:
            return ckpt.load_checkpoint(path, template)
        except ValueError as e:
            if "ema" in template and "missing leaves: ['ema" in str(e):
                no_ema = {k: v for k, v in template.items() if k != "ema"}
                state, extra = ckpt.load_checkpoint(path, no_ema)
                state["ema"] = opt.tree_map(lambda p: p.to(torch.float32, copy=True), state["params"])
                self.logger.log({"event": "ema_seeded_from_params", "from": path})
                return state, extra
            raise

    def _adopt_restored(self, state: Any, extra: Dict[str, Any]) -> int:
        """Install a loaded checkpoint as the live state and the sampler's
        frontier; returns the restored step. A live state of the same tree
        is overwritten in place, so every reference to its tensors sees the
        restored values. A file whose blocks are in the interleaved
        rank-major layout (``block_layout``: "interleaved") is read back to
        depth-major first, as the JAX trainer reads it."""
        if extra.get("block_layout", "depth_major") == "interleaved":
            state = ts.bake_state_layout(state, self.config, forward=False)
        if self.mesh is not None:
            state = ts.shard_train_state(state, self.mesh, self.config)
        live = getattr(self, "state", None)
        new = dict(opt.tree_leaves(state))
        old = dict(opt.tree_leaves(live)) if live is not None else {}
        if old.keys() == new.keys() and all(
                old[k].shape == new[k].shape and old[k].dtype == new[k].dtype for k in new):
            with torch.no_grad():
                for k, t in new.items():
                    old[k].copy_(t)
        else:
            self.state = opt.tree_map(lambda x: x.to(self.device), state)
        rng_state = extra.get("data_rng")
        if rng_state is not None and hasattr(self.train_iterator, "set_state"):
            self.train_iterator.set_state(rng_state)
        return int(extra.get("step", 0))

    def _drop_feed(self) -> None:
        """Close the prefetch feed without rewinding the source: a rollback
        sets the sampler's state right after, so the queued batches of the
        poison window are discarded."""
        if self._feed is not None:
            self._feed.close()
            self._feed = None

    def _skip_batches(self, n: int) -> None:
        """Move the data frontier by drawing and discarding n host batches."""
        for _ in range(n):
            next(self.train_iterator)

    def _put(self, batch: HostBatch, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host batch (the node's rows) -> this rank's rows (along ``axis``)
        as device tensors (pinned memory, non-blocking copy on a card)."""
        rows = (slice(None),) * axis + (self._rows,)

        def one(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a[rows]))
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
                mcfg.vocab_size, mcfg.context_length, self._node_batch, self._node_seed(eval_seed))
        return self._make_iterator(dcfg.val_path, eval_seed)

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
        return float(self.eval_loop(self.state, self._put(batch, axis=1)))

    def save(self, step: int, *, sync: bool = False) -> Optional[str]:
        """Write a checkpoint of this step. With ``train.checkpoint_async``
        (and not ``sync``), the state is copied to host memory here and
        written on a thread: returns None. Every save is a span and a
        ``ckpt_save`` event (``background`` when the write goes on after)."""
        t0 = time.perf_counter()
        with self.obs.spans.span("ckpt_save"):
            result = self._save_impl(step, sync=sync)
        self.obs.bus.emit("ckpt_save", step=step, dur_s=time.perf_counter() - t0, background=result is None)
        return result

    def _frontier(self) -> Any:
        """The sampler's state at the consumed-batch frontier: with the
        prefetcher running the source is ahead by the queue, so the feed's."""
        rng_src = self._feed if self._feed is not None else self.train_iterator
        return rng_src.state() if hasattr(rng_src, "state") else None

    def _mark_boundary(self, step: int) -> None:
        """``step`` is complete and nothing of the next one has run: record
        its data frontier for the emergency save, which may fire while the
        loop draws the next batch and so moves the live frontier past it."""
        with self._boundary:
            self._completed_step = step
            self._boundary_frontier = self._frontier()
            self._at_boundary = True

    def _save_kwargs(self, step: int, frontier: Any) -> Dict[str, Any]:
        extra: Dict[str, Any] = {
            "step": step,
            "config": dataclasses.asdict(self.config),
            "preset": self.config.name,
            "block_layout": "depth_major",
        }
        local_extra = {"data_rng": frontier} if frontier is not None else {}
        return dict(extra=extra, local_extra=local_extra, keep=self.config.train.keep_checkpoints)

    def _save_impl(self, step: int, *, sync: bool = False) -> Optional[str]:
        kwargs = self._save_kwargs(step, self._frontier())
        directory = self.config.train.checkpoint_dir
        if self.config.train.checkpoint_async and not sync and pmesh.world_size() == 1:
            self._writer.save(directory, step, self.state, **kwargs)
            return None
        self.join_pending_save()  # never two writes into the directory at once
        state = ts.save_view(self.state, self.config, self.mesh)  # depth-major
        return ckpt.save_checkpoint(directory, step, state, layout=self._ckpt_layout, **kwargs)

    def join_pending_save(self) -> None:
        """Wait for an async checkpoint write in flight; raise
        ``RuntimeError`` from its error."""
        self._writer.join()

    def _emergency_save(self) -> None:
        """The watchdog's bounded last save before EXIT_WEDGED. Taken only at
        a step boundary (``_at_boundary``, under the lock the loop holds
        while it leaves one): the device-to-host copies are enqueued on the
        training stream there, so stream order gives the completed step's
        values even though the optimizer updates in place; the data frontier
        is the one recorded with that step (``_mark_boundary``), since the
        loop may already be drawing the next batch. Elsewhere it logs
        ``emergency_save_skipped`` and writes nothing. Everything runs on a
        thread that is abandoned after ``EMERGENCY_SAVE_TIMEOUT_S`` (a wedged
        device blocks the copy; an abandoned ``tmp-<step>`` is invisible and
        collected by the next restore). Several ranks save collectively and
        a wedge is usually collective, so only a single process saves."""
        if pmesh.world_size() > 1:
            return
        if not self._writer.idle(timeout=10.0):
            self.logger.log({"event": "emergency_save_skipped", "step": self._completed_step,
                             "why": "async checkpoint write still running"})
            return
        done = threading.Event()
        outcome: Dict[str, Any] = {}

        def write() -> None:
            try:
                if self._profiler is not None:
                    self._profiler.close()
                t0 = time.perf_counter()
                with self._boundary:
                    if not self._at_boundary:
                        outcome["skipped"] = True
                        return
                    step = outcome["step"] = self._completed_step
                    kwargs = self._save_kwargs(step, self._boundary_frontier)
                    host, ready = _snapshot(self.state, self._train_stream)
                self.logger.log({"event": "emergency_checkpoint", "step": step})
                ready()
                ckpt.save_checkpoint(self.config.train.checkpoint_dir, step, host, **kwargs)
                self.obs.bus.emit("ckpt_save", step=step, dur_s=time.perf_counter() - t0, background=False,
                                  emergency=True)
            except Exception as e:
                self.logger.log({"event": "emergency_save_failed", "error": repr(e)[:200]})
            finally:
                done.set()

        threading.Thread(target=write, daemon=True).start()
        if not done.wait(timeout=self.EMERGENCY_SAVE_TIMEOUT_S):
            self.logger.log({"event": "emergency_checkpoint_stalled", "step": outcome.get("step")})
        elif outcome.get("skipped"):
            self.logger.log({"event": "emergency_save_skipped", "step": self._completed_step,
                             "why": "not at a step boundary"})

    def _install_preemption_handler(self) -> Any:
        """SIGTERM -> a graceful stop at the next log boundary. Returns the
        previous handler, or ``_NOT_INSTALLED`` off the main thread."""
        def handler(signum, frame):  # noqa: ARG001 - the signal API's shape
            self._stop_requested = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return Trainer._NOT_INSTALLED

    def _stop_synced(self) -> bool:
        """Whether any rank was asked to stop: a SIGTERM may reach one rank
        first, and every rank must enter the collective save together.
        Called at log boundaries only."""
        return pmesh.all_ranks_agree(self._stop_requested, any_of=True)

    def train(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Train until the state's step reaches ``steps`` (default
        ``train.train_steps``): a later call continues where the previous
        one stopped. Returns the last logged metrics; ``exit_reason`` says
        why it ended."""
        tcfg, rcfg = self.config.train, self.config.resilience
        total = steps if steps is not None else tcfg.train_steps
        tokens_per_step = tcfg.batch_size * self.config.model.context_length
        step = start = int(self.state["step"])
        self._stop_requested = False  # a previous run's SIGTERM must not carry over
        self.exit_reason = "completed"
        self._mark_boundary(step)
        self._train_stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        prev_sigterm = self._install_preemption_handler()
        profiler = self._profiler = StepProfiler(tcfg.profile_dir, tcfg.profile_start, tcfg.profile_steps)
        self.obs.start_run(start, total, sampler=self.sampler)

        detector = rollback_mgr = faults = watchdog = None
        if rcfg.anomaly_detection:
            from pretraining_llm_tpu_torch.resilience.anomaly import AnomalyDetector
            from pretraining_llm_tpu_torch.resilience.rollback import RollbackManager

            detector = AnomalyDetector(rcfg)
            rollback_mgr = RollbackManager(rcfg, logger=self.logger, bus=self.obs.bus)
        if rcfg.faults:
            from pretraining_llm_tpu_torch.resilience.faults import FaultInjector

            faults = FaultInjector(rcfg.faults, start_step=start, logger=self.logger, bus=self.obs.bus)
        if rcfg.watchdog_timeout_s > 0:
            from pretraining_llm_tpu_torch.resilience.watchdog import StepWatchdog

            watchdog = StepWatchdog(rcfg.watchdog_timeout_s, on_timeout=self._emergency_save,
                                    logger=self.logger, bus=self.obs.bus).start()

        last: Dict[str, float] = {}
        preempted = False
        try:
            while step < total:
                # Built inside the loop so that a rollback's _drop_feed gets
                # a fresh feed on the moved sampler.
                if self._feed is None and self.config.data.prefetch > 0:
                    self._feed = data_loader.DevicePrefetcher(
                        self.train_iterator, self._put_ahead, self.config.data.prefetch)
                profiler.step(step)
                if faults is not None:
                    with self.obs.suppressed_compiles():
                        faults.maybe_fire(step, self)
                if self._feed is not None:
                    batch = next(self._feed)
                else:
                    batch = self._put(next(self.train_iterator))
                with self._boundary:
                    self._at_boundary = False
                self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                self._mark_boundary(step)
                self.throughput.tick(tokens_per_step)
                if step == start + 1:
                    self.obs.mark_warm(step)  # later builds are recompiles
                if watchdog is not None:
                    watchdog.heartbeat()  # the first beat arms it

                at_log = step % tcfg.log_interval == 0 or step == total
                if at_log and self._stop_synced():
                    preempted = True
                    self.exit_reason = "preempted"
                    self.obs.bus.emit("preempt", step=step)
                    self.logger.log({"event": "preempted", "step": step})
                    with _watchdog_paused(watchdog):
                        self.save(step, sync=True)
                    break
                off_path = False
                if at_log:
                    last = {k: float(v) for k, v in metrics.items()}  # device sync
                    last.update(self.throughput.window())
                    last.update(self.obs.on_log_boundary(step, last, last))
                    self.logger.log({"step": step, **last})
                    if detector is not None:
                        anomaly = detector.observe(step, last)
                        if anomaly is not None:
                            self.logger.log(anomaly.as_event())
                            with _watchdog_paused(watchdog), self.obs.suppressed_compiles():
                                outcome = rollback_mgr.handle(self, anomaly)
                            if outcome == "rolled_back":
                                detector.reset()
                                step = rollback_mgr.last_restored
                                self._mark_boundary(step)
                                self.throughput.reset_clock()
                                continue
                            if outcome in ("exhausted", "no_checkpoint"):
                                self.exit_reason = ("anomaly_budget" if outcome == "exhausted"
                                                    else "anomaly_no_checkpoint")
                                break
                            # "suppressed": inside the cooldown; go on.
                if tcfg.eval_interval > 0 and step % tcfg.eval_interval == 0:
                    with _watchdog_paused(watchdog), self.obs.timed_event("eval", step=step) as ev:
                        val_loss = ev["val_loss"] = self.evaluate()
                    eval_metrics = {
                        "val_loss": val_loss,
                        "val_ppl": math.exp(val_loss) if val_loss < 700 else float("inf"),
                        "val_bits_per_token": val_loss / math.log(2.0),
                    }
                    last.update(eval_metrics)
                    self.logger.log({"step": step, **eval_metrics})
                    off_path = True
                if tcfg.checkpoint_interval > 0 and step % tcfg.checkpoint_interval == 0:
                    with _watchdog_paused(watchdog):
                        self.save(step)
                    off_path = True
                if off_path:
                    self.throughput.reset_clock()  # keep eval/save time out of step_ms
        except Exception as e:
            # Persist the last good state before propagating: the step
            # raises before its optimizer update (a NaN check, a kernel
            # error), so self.state is still the previous step's.
            self.obs.bus.emit("failure", step=step, error=repr(e)[:200])
            self.logger.log({"event": "failure", "step": step, "error": repr(e)[:200]})
            try:
                with _watchdog_paused(watchdog):
                    self.save(step, sync=True)
            except Exception as save_err:  # keep the original error primary
                self.logger.log({"event": "emergency_save_failed", "error": repr(save_err)[:200]})
            raise
        finally:
            propagating = sys.exc_info()[0] is not None
            profiler.close()
            if watchdog is not None:
                watchdog.stop()  # before the joins below: a slow final save is no wedge
            if prev_sigterm is not Trainer._NOT_INSTALLED:
                signal.signal(signal.SIGTERM, prev_sigterm)
            self._close_feed()
            try:
                self.join_pending_save()
            except RuntimeError:
                self.logger.log({"event": "async_checkpoint_failed", "step": step})
                if not propagating:
                    raise
            finally:
                if propagating:  # run_end must close the stream on every path
                    self.obs.end_run("exception", step=step)
                if self._owns_logger:
                    self.logger.close()
        if preempted:
            self.obs.end_run(self.exit_reason, step=step)
            return last  # checkpointed at the stop step
        # The final save only for a completed run: after an anomaly stop the
        # live state is the poisoned one.
        if (tcfg.save_final and self.exit_reason == "completed"
                and (tcfg.checkpoint_interval <= 0 or step % tcfg.checkpoint_interval != 0)):
            self.save(step, sync=True)
        self.obs.end_run(self.exit_reason, step=step)
        return last


def _snapshot(state: Any, stream: Optional[torch.cuda.Stream]) -> Tuple[Any, Any]:
    """Host copies of ``state``'s tensors and a function that waits for them.
    On a card the copies go into pinned memory on ``stream`` (non-blocking,
    so they are ordered after the work already enqueued there); on the CPU
    they are clones."""
    if stream is None:
        return opt.tree_map(lambda t: t.detach().clone(), state), lambda: None
    with torch.cuda.stream(stream):
        host = opt.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True), state)
        copied = torch.cuda.Event()
        copied.record(stream)
    return host, copied.synchronize

"""Deterministic fault drills for training and serving (the JAX package's
``resilience/faults.py``).

Plan grammar (``ResilienceConfig.faults``): comma-separated ``kind@step``
entries, e.g. ``"nan@20,sigterm@50"``. A fault fires right before that step
runs, after ``step`` completed steps:

  nan            multiply every parameter by NaN: the next loss is NaN and
                 the detector must roll back at the next log boundary;
  sigterm        send this process SIGTERM: the trainer checkpoints and
                 stops at the next log boundary (EXIT_PREEMPTED);
  hang           block the host loop: the step watchdog must fire, save an
                 emergency checkpoint and exit EXIT_WEDGED;
  ckpt_truncate  truncate one ``.npy`` leaf of the newest checkpoint: the
                 next restore must fall back to the previous good step.

Each entry fires at most once per process, and a resumed run never fires
an entry at or below its start step, so a supervisor's relaunch after an
injected hang resumes from the emergency checkpoint and runs on.

Serving drills (``--serving_faults``, ``ServingFaultInjector``) count
REQUESTS instead of steps: ``kind@reqN`` fires when a replica accepts its
Nth submission, ``kind@reqN:rM`` only on replica M. The corruption kinds
act on the engine of that replica alone: ``corrupt_weights`` swaps a
negated copy of one parameter into that engine's tree (replicas of one
process share their parameter tensors, so an in-place negation would
corrupt every one of them), and ``corrupt_kv_page`` overwrites one block
of that engine's pools in place, on the loop thread that owns them.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FAULT_KINDS = ("nan", "sigterm", "hang", "ckpt_truncate")
# Serving-path fault kinds (frontend/router.py drills). Same philosophy as
# the training kinds — every fleet recovery path must be exercisable on CPU
# in tier-1 — but the trigger is a REQUEST count, not a step count: serving
# has no step clock, and "the Nth submission to a replica" is deterministic
# under a seeded load schedule.
SERVING_FAULT_KINDS = (
    "replica_crash",  # next scheduler turn on the replica raises -> loop dies
    "replica_hang",   # next scheduler turn blocks (wedged-engine drill)
    "slow_window",    # next few turns run with an injected delay (SLO drill)
    "reject_storm",   # next few submissions to the replica are refused busy
    # Silent-corruption kinds (integrity drills): the replica keeps
    # answering — only its OUTPUTS are wrong — so crash/hang detection
    # never fires and the output-integrity sentinel has to catch it.
    "corrupt_kv_page",  # flip a published prefix-cache pool page in place
    "corrupt_weights",  # negate the largest param leaf (bit-rot drill)
    "wrong_token",      # force one out-of-vocab token id into the commit path
    # Process-level kinds (frontend/remote_replica.py drills): executed by
    # the PARENT against a worker process right after the triggering
    # submit is accepted. In-process replicas arm them but nothing
    # consumes the queue — they are no-ops without a process boundary.
    "worker_kill",    # SIGKILL the worker process (hard crash, no cleanup)
    "worker_stall",   # worker stops reading frames but stays alive
    "conn_drop",      # sever the parent<->worker socket; both ends survive
    "partition",      # blackhole the socket: reads hang, writes buffer —
                      # no RST/EOF, so only leases + fencing can detect it
                      # (heal via FleetAction kind="heal" or replica.heal())
    "wire_delay",     # add per-recv delay + jitter (slow WAN link drill)
    # KV-migration corruption (disaggregation drill): flip bytes in the
    # next in-flight kv_page transfer pushed THROUGH the scoped replica's
    # connection (armed at the Nth accepted submission, consumed by the
    # sender side of the next push) — the receiver must detect the digest
    # mismatch, drop the page, and let the request re-prefill. Works for
    # in-process and process fleets alike: the flip happens on the
    # serialized transfer, before (or instead of) the wire.
    "corrupt_kv_migration",
)

# The subset above that needs a process boundary to mean anything.
# corrupt_kv_migration is sender-side (the parent corrupts the serialized
# transfer before pushing), so in process fleets it must ride in the
# PARENT's plan half, like the kill/stall/sever kinds.
PROCESS_SERVING_FAULT_KINDS = (
    "worker_kill", "worker_stall", "conn_drop", "partition", "wire_delay",
    "corrupt_kv_migration",
)


# How long an injected hang blocks (training and serving): forever next to
# any watchdog timeout, bounded so a run without a watchdog still ends.
_HANG_SECONDS = 3600.0


def parse_faults(spec: str) -> List[Tuple[str, int]]:
    """Parse a fault plan; raises ValueError naming the offending entry."""
    out: List[Tuple[str, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, at = entry.partition("@")
        if not sep or not at:
            raise ValueError(f"malformed fault entry {entry!r} in {spec!r}: expected kind@step")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r}; one of {FAULT_KINDS}")
        try:
            step = int(at)
        except ValueError:
            raise ValueError(f"fault step must be an integer in {entry!r} (plan {spec!r})") from None
        if step < 1:
            raise ValueError(
                f"fault step must be >= 1 in {entry!r} (step 0 is never "
                "reachable: faults fire only past the run's start step)"
            )
        out.append((kind, step))
    if not out:
        raise ValueError(f"empty fault plan {spec!r}")
    return out


class FaultInjector:
    """Fires the parsed plan against a live ``Trainer``, once per entry.
    Entries at or below ``start_step`` (the step the run resumed from) fired
    in the lineage that wrote the checkpoint and are spent."""

    def __init__(self, spec: str, *, start_step: int = 0, logger: Any = None, bus: Any = None) -> None:
        self.plan = parse_faults(spec)
        self.start_step = start_step
        self.logger = logger
        self.bus = bus
        self._fired: set = set()

    def maybe_fire(self, step: int, trainer: Any) -> None:
        for i, (kind, at) in enumerate(self.plan):
            if at != step or at <= self.start_step or i in self._fired:
                continue
            self._fired.add(i)
            if self.logger is not None:
                self.logger.log({"event": "fault_injected", "kind": kind, "step": step})
            if self.bus is not None:
                # Before the action: sigterm and hang never hand control back.
                self.bus.emit("fault_injected", step=step, fault=kind)
            getattr(self, f"_fire_{kind}")(trainer)

    def _fire_nan(self, trainer: Any) -> None:
        # In place, as the optimizer updates the parameters.
        from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

        with torch.no_grad():
            for _, p in tree_leaves(trainer.state["params"]):
                if p.is_floating_point():
                    p.mul_(float("nan"))

    def _fire_sigterm(self, trainer: Any) -> None:  # noqa: ARG002 - one shape for every kind
        os.kill(os.getpid(), signal.SIGTERM)

    def _fire_hang(self, trainer: Any) -> None:  # noqa: ARG002
        time.sleep(_HANG_SECONDS)

    def _fire_ckpt_truncate(self, trainer: Any) -> None:
        from pretraining_llm_tpu_torch.training import checkpoint as ckpt

        trainer.join_pending_save()  # the newest checkpoint is on disk first
        latest = ckpt.latest_checkpoint(trainer.config.train.checkpoint_dir)
        if latest is not None:
            truncate_leaf(latest)


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One parsed serving-fault entry: fire ``kind`` when a replica sees
    its ``at_submit``-th accepted submission. ``replica=None`` means any
    replica (whichever reaches the count first)."""

    kind: str
    at_submit: int
    replica: Optional[int] = None


def parse_serving_faults(spec: str) -> List[ServingFault]:
    """Parse a serving fault plan: comma-separated ``kind@reqN`` entries,
    optionally replica-scoped as ``kind@reqN:rM`` (e.g.
    ``"replica_crash@req3,slow_window@req1:r0"``). Raises ValueError
    naming the offending entry."""
    out: List[ServingFault] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, at = entry.partition("@")
        if not sep or not at or not at.startswith("req"):
            raise ValueError(
                f"malformed serving fault entry {entry!r} in {spec!r}: "
                f"expected kind@reqN or kind@reqN:rM"
            )
        if kind not in SERVING_FAULT_KINDS:
            raise ValueError(
                f"unknown serving fault kind {kind!r} in {spec!r}; one of "
                f"{SERVING_FAULT_KINDS}"
            )
        at = at[len("req"):]
        at, rsep, rep = at.partition(":")
        replica: Optional[int] = None
        if rsep:
            if not rep.startswith("r"):
                raise ValueError(
                    f"malformed replica scope in {entry!r} (plan {spec!r}): "
                    f"expected :rM"
                )
            try:
                replica = int(rep[1:])
            except ValueError:
                raise ValueError(
                    f"replica index must be an integer in {entry!r} "
                    f"(plan {spec!r})"
                ) from None
            if replica < 0:
                raise ValueError(
                    f"replica index must be >= 0 in {entry!r} (plan {spec!r})"
                )
        try:
            n = int(at)
        except ValueError:
            raise ValueError(
                f"fault request count must be an integer in {entry!r} "
                f"(plan {spec!r})"
            ) from None
        if n < 1:
            raise ValueError(
                f"fault request count must be >= 1 in {entry!r} "
                f"(plan {spec!r})"
            )
        out.append(ServingFault(kind, n, replica))
    if not out:
        raise ValueError(f"empty serving fault plan {spec!r}")
    return out


def split_serving_plan(spec: str) -> Tuple[str, str]:
    """Split one plan string into (engine_plan, process_plan) — both in
    the same ``kind@reqN[:rM]`` grammar, either possibly "". Process-mode
    serving needs this because the two halves run in different
    processes: engine kinds ride in each worker's spec and fire inside
    its scheduler, while process kinds stay with the parent-side
    injector that can actually kill/stall/sever a worker. Keeping one
    user-facing plan string (``--serving_faults``) with both vocabularies
    means drills read the same regardless of replica mode."""
    parse_serving_faults(spec)  # validate once; errors name the entry
    engine: List[str] = []
    process: List[str] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind = entry.partition("@")[0]
        (process if kind in PROCESS_SERVING_FAULT_KINDS else engine).append(
            entry
        )
    return ",".join(engine), ",".join(process)


class InjectedFault(RuntimeError):
    """Raised inside a replica's scheduler turn by ``replica_crash`` — the
    engine loop's failure path treats it like any real engine error."""


class ServingFaultInjector:
    """Fires a parsed serving plan against a fleet of replicas, once per
    entry. Shared across the fleet: each Replica reports its accepted
    submissions via ``on_submit`` (router/gateway threads) which ARMS the
    matching entries; the armed action then fires at the replica's next
    scheduler turn via the ``wrap_tick`` shim (loop thread) or, for
    ``reject_storm``, at its next submissions via ``should_reject``.

    Arming at submit + firing at the turn boundary keeps the drill honest:
    a crash lands while the triggering request (at least) is in flight, so
    the redrive path — not just fresh routing — is what recovers it.
    """

    def __init__(
        self,
        spec: str,
        *,
        bus: Any = None,
        slow_ticks: int = 4,
        slow_s: float = 0.05,
        storm_rejects: int = 4,
    ) -> None:
        self.plan = parse_serving_faults(spec)
        self.bus = bus
        self.slow_ticks = int(slow_ticks)
        self.slow_s = float(slow_s)
        self.storm_rejects = int(storm_rejects)
        self._lock = threading.Lock()
        self._fired: set = set()
        self._armed: Dict[int, List[str]] = {}   # replica -> crash/hang queue
        self._slow: Dict[int, int] = {}          # replica -> slowed ticks left
        self._storm: Dict[int, int] = {}         # replica -> rejects left
        self._corrupt: Dict[int, List[str]] = {}  # replica -> corruption queue
        self._process: Dict[int, List[str]] = {}  # replica -> process faults
        self._kv_corrupt: Dict[int, int] = {}    # replica -> armed kv flips
        self._engines: Dict[int, Any] = {}       # replica -> live engine handle

    def attach_engine(self, replica: int, engine: Any) -> None:
        """Give the injector the replica's LIVE engine (called from
        Replica._launch_locked on every launch/relaunch): the corruption
        kinds mutate engine state in place, which crash/hang never needed.
        A relaunch re-attaches, so a quarantined replica's fresh engine is
        the one any still-armed entries would hit."""
        with self._lock:
            self._engines[replica] = engine

    def on_submit(self, replica: int, nth_submit: int) -> None:
        """Called by a Replica after accepting its ``nth_submit``-th
        request; arms any plan entries that trigger there."""
        with self._lock:
            for i, f in enumerate(self.plan):
                if (
                    i in self._fired
                    or f.at_submit != nth_submit
                    or (f.replica is not None and f.replica != replica)
                ):
                    continue
                self._fired.add(i)
                if self.bus is not None:
                    self.bus.emit(
                        "fault_injected", fault=f.kind, replica=replica,
                        req_n=nth_submit,
                    )
                if f.kind in ("replica_crash", "replica_hang"):
                    self._armed.setdefault(replica, []).append(f.kind)
                elif f.kind == "corrupt_kv_migration":
                    # Sender-side: consumed by the next kv-page push
                    # through this replica (take_kv_corruption), not by
                    # the generic process-fault drain.
                    self._kv_corrupt[replica] = (
                        self._kv_corrupt.get(replica, 0) + 1
                    )
                elif f.kind in PROCESS_SERVING_FAULT_KINDS:
                    self._process.setdefault(replica, []).append(f.kind)
                elif f.kind in (
                    "corrupt_kv_page", "corrupt_weights", "wrong_token"
                ):
                    self._corrupt.setdefault(replica, []).append(f.kind)
                elif f.kind == "slow_window":
                    self._slow[replica] = (
                        self._slow.get(replica, 0) + self.slow_ticks
                    )
                else:  # reject_storm
                    self._storm[replica] = (
                        self._storm.get(replica, 0) + self.storm_rejects
                    )

    def should_reject(self, replica: int) -> bool:
        """Consume one reject_storm token for this replica (submit path)."""
        with self._lock:
            left = self._storm.get(replica, 0)
            if left <= 0:
                return False
            self._storm[replica] = left - 1
            return True

    def take_process_faults(self, replica: int) -> List[str]:
        """Drain the armed process-level faults for ``replica``. Called
        by RemoteReplica right after the triggering submit's reply, on
        the submitting thread — the parent is the only party that can
        kill/stall/sever a worker process. In-process fleets never call
        this, which is exactly why process kinds are no-ops there."""
        with self._lock:
            return self._process.pop(replica, [])

    def take_kv_corruption(self, replica: int) -> int:
        """Drain the armed ``corrupt_kv_migration`` count for ``replica``.
        Called by the kv-page push path (Replica.push_kv_pages /
        RemoteReplica.push_kv_pages) right before serializing onto the
        wire; a nonzero return means: flip bytes in this transfer."""
        with self._lock:
            return self._kv_corrupt.pop(replica, 0)

    def wrap_tick(self, replica: int, tick: Any) -> Any:
        """Shim for ``engine.pipeline_tick``: checks armed actions before
        delegating. Installed as an instance attribute on the engine (the
        same shadowing trick the throttle tests use), so the engine class
        stays untouched."""

        def _tick(*a: Any, **kw: Any) -> Any:
            with self._lock:
                armed = self._armed.get(replica, [])
                action = armed.pop(0) if armed else None
                slow = self._slow.get(replica, 0)
                if action is None and slow > 0:
                    self._slow[replica] = slow - 1
                corrupt = self._corrupt.get(replica, [])
                corruption = corrupt.pop(0) if corrupt else None
                engine = self._engines.get(replica)
            if corruption is not None:
                # Fired on the loop thread (the engine's owner), BEFORE the
                # turn, so the very next dispatched window runs against the
                # corrupted state. A corruption with no target yet (e.g. a
                # KV flip before anything is cached) stays armed.
                if not self._fire_corruption(corruption, replica, engine):
                    with self._lock:
                        self._corrupt.setdefault(replica, []).insert(
                            0, corruption
                        )
            if action == "replica_crash":
                raise InjectedFault(f"injected replica_crash on replica {replica}")
            if action == "replica_hang":
                time.sleep(_HANG_SECONDS)
            elif action is None and slow > 0:
                time.sleep(self.slow_s)
            return tick(*a, **kw)

        return _tick

    # -- corruption actions (integrity drills) -------------------------

    def _fire_corruption(
        self, kind: str, replica: int, engine: Any
    ) -> bool:
        """Mutate the attached engine's state in place; returns False when
        the fault has no target yet and should stay armed."""
        if engine is None:
            return False
        fired = getattr(self, f"_fire_{kind}")(engine)
        if fired and self.bus is not None:
            self.bus.emit("fault_fired", fault=kind, replica=replica)
        return fired

    @staticmethod
    def _fire_corrupt_kv_page(engine: Any) -> bool:
        """Overwrite one PUBLISHED prefix-cache pool block with garbage,
        in place: the silent version of a DMA bit-flip on a shared page.
        Targets the lowest cached block id so the drill is deterministic;
        with no cache (or nothing published yet) it waits for one.

        Poisons EVERY pool leaf at that block: K/V on an exact pool, the
        int8 code pages AND their scale leaves on a quantized one (100.0
        in every float leaf, 101 in every integer leaf, since a sign flip
        would leave an all-zero page and its digest intact)."""
        from pretraining_llm_tpu_torch.resilience.integrity import _leaves

        cache = getattr(engine, "prefix_cache", None)
        if cache is None:
            return False
        cached = cache.cached_block_ids()
        if not cached:
            return False
        block = cached[0]
        with torch.no_grad():
            for leaf in _leaves(engine.pools):
                page = leaf[:, block] if leaf.ndim >= 5 else leaf[block]
                page.fill_(100.0 if leaf.is_floating_point() else 101)
        return True

    @staticmethod
    def _fire_corrupt_weights(engine: Any) -> bool:
        """Negate the largest floating param leaf (the embedding table on
        any realistic config): every forward pass afterwards is wrong, but
        nothing crashes, the failure the golden probes and the weight
        fingerprint exist to catch. The negated leaf is a new tensor in a
        copy of this engine's tree: the other replicas keep theirs."""
        from pretraining_llm_tpu_torch.training.optimizer import tree_leaves, tree_map

        floats = [leaf for _, leaf in tree_leaves(engine.params)
                  if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
        if not floats:
            return False
        target = max(floats, key=lambda leaf: leaf.numel())  # the first of the largest, as JAX picks
        engine.params = tree_map(lambda leaf: leaf.neg() if leaf is target else leaf, engine.params)
        return True

    @staticmethod
    def _fire_wrong_token(engine: Any) -> bool:
        """Force the next committed token id out of vocab range by
        shadowing ``engine._consume_tokens`` (one shot, then restored):
        proves the reap-time sanity guard end to end. The guard must
        raise before the garbage id reaches any client stream."""
        orig = engine._consume_tokens

        def _bad(req, row, toks, advance_seq=True, **kw):
            # **kw forwards commit-path extras (the logprob sliver)
            # untouched; only the token ids are forged.
            if len(toks) == 0:
                return orig(req, row, toks, advance_seq, **kw)
            engine._consume_tokens = orig
            bad = np.array(
                [engine.cfg.vocab_size + 7] + [int(t) for t in toks[1:]],
                dtype=np.int64,
            )
            return orig(req, row, bad, advance_seq, **kw)

        engine._consume_tokens = _bad
        return True


def truncate_leaf(ckpt_path: str, leaf: Optional[str] = None) -> Optional[str]:
    """Truncate one ``.npy`` leaf of a checkpoint dir to half its size (a torn
    write). Returns the damaged file's name, or None if there is no leaf."""
    names = sorted(n for n in os.listdir(ckpt_path) if n.endswith(".npy"))
    if leaf is not None:
        names = [n for n in names if n.startswith(leaf)]
    if not names:
        return None
    target = os.path.join(ckpt_path, names[0])
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, size // 2))
    return names[0]

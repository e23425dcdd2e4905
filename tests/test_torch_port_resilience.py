"""The port's resilience loop (``pretraining_llm_tpu_torch/resilience/``,
``training/checkpoint.py::restore_latest``, the trainer's wiring, the train
CLI's return codes and ``supervisor.py``) against the JAX package's.

Held against JAX on the same inputs: the config's validation messages, the
fault grammar, the detector's anomalies on the same metric sequences,
``restore_latest``'s choice on the same corrupt directories, and a port
``Trainer`` and a JAX ``Trainer`` from one init on one token file under
``nan@5``: the same flagged step, restored step and skipped batches, and
every logged loss within the train-step bar (1e-5 relative). The drills of
``tests/test_resilience.py`` run on the port: budget exhaustion, no
checkpoint, SIGTERM, truncate-then-resume, no re-fire, the watchdog's exit
45 with an emergency checkpoint (a subprocess), the supervisor relaunching
a drilled run to the clean run's final state bit for bit (a subprocess),
and the supervisor's policy on stand-in children.
"""

import dataclasses
import functools
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.resilience import anomaly as janomaly
from pretraining_llm_tpu.resilience import faults as jfaults
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu.training.trainer import Trainer as JTrainer
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import train as tcli
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.resilience import EXIT_ANOMALY, EXIT_PREEMPTED, EXIT_WEDGED
from pretraining_llm_tpu_torch.resilience import anomaly as tanomaly
from pretraining_llm_tpu_torch.resilience import faults as tfaults
from pretraining_llm_tpu_torch.resilience.watchdog import StepWatchdog
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5  # the train-step bar of tests/test_torch_port_training.py
# No QKV bias: its gradient is rounding noise that Adam blows up to +-lr in
# either package (tests/test_torch_port_training.py::TRAIN_MODEL).
MODEL = dict(vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2, activation="gelu",
             norm="layernorm", pos_embed="learned", tie_embeddings=True, qkv_bias=False, mlp_bias=True,
             compute_dtype="float32", attention_impl="flash")


class _Records:
    """A logger that keeps every record."""

    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(dict(record))

    def events(self, kind):
        return [r for r in self.records if r.get("event") == kind]

    def losses(self):
        return [(r["step"], r["loss"]) for r in self.records if "loss" in r]


def _tiny(tmp_path, train=None, res=None, **top):
    """The tiny preset at fp32 with anomaly detection, 16 steps, a checkpoint
    every 4, a log line every 2."""
    over = {"model.compute_dtype": "float32", "resilience.anomaly_detection": True}
    over.update({f"train.{k}": v for k, v in dict(dict(
        train_steps=16, checkpoint_interval=4, log_interval=2, eval_interval=0,
        checkpoint_dir=str(tmp_path / "ck")), **(train or {})).items()})
    over.update({f"resilience.{k}": v for k, v in (res or {}).items()})
    over.update(top)
    return tcfg.get_preset("tiny").with_overrides(over)


def _trainer(cfg, resume=False, logger=None):
    return Trainer(cfg, synthetic_data=True, resume=resume, logger=logger or _Records(), device="cpu")


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("kw", [
    dict(anomaly_window=1), dict(anomaly_min_history=0), dict(loss_spike_factor=1.0),
    dict(grad_spike_factor=0.5), dict(rollback_budget=-1), dict(cooldown_steps=-1),
    dict(watchdog_timeout_s=-1.0), dict(faults="nan@0"), dict(faults="frobnicate@5"), dict(faults="hang"),
])
def test_resilience_config_refuses_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        jcfg.ResilienceConfig(**kw)
    with pytest.raises(ValueError) as got:
        tcfg.ResilienceConfig(**kw)
    assert str(got.value) == str(want.value)


def test_resilience_and_obs_sections_are_ported():
    over = {"resilience.anomaly_detection": True, "resilience.faults": "nan@9, sigterm@20",
            "resilience.watchdog_timeout_s": 3.0, "obs.events_path": "e.jsonl", "obs.device_memory_interval": 2}
    got = tcfg.get_preset("tiny").with_overrides(over)
    want = jcfg.get_preset("tiny").with_overrides(over)
    assert dataclasses.asdict(got.resilience) == dataclasses.asdict(want.resilience)
    assert dataclasses.asdict(got.obs) == dataclasses.asdict(want.obs)
    assert tcfg.Config.from_dict(dataclasses.asdict(want)).resilience == got.resilience
    assert dataclasses.asdict(got.with_overrides({"mesh.data": 1}).mesh) == dataclasses.asdict(
        want.with_overrides({"mesh.data": 1}).mesh)
    fover = {"frontend.port": 1, "frontend.trace_sample": 0.5}
    assert dataclasses.asdict(got.with_overrides(fover).frontend) == dataclasses.asdict(
        want.with_overrides(fover).frontend)
    with pytest.raises(KeyError):
        got.with_overrides({"resilience.nope": 1})


@pytest.mark.parametrize("spec", ["nan@9,sigterm@20", " hang@3 , ckpt_truncate@40 ", "", "hang", "bogus@3",
                                  "nan@x", "nan@-1"])
def test_parse_faults_matches_jax(spec):
    try:
        want = jfaults.parse_faults(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_faults(spec)
        assert str(got.value) == str(e)
        return
    assert tfaults.parse_faults(spec) == want


# ---------------------------------------------------------------- detector


def _sequences():
    rng = np.random.default_rng(7)
    base = [{"loss": float(3.0 - 0.01 * i + rng.normal(0, 0.05)), "grad_norm": float(1.0 + rng.normal(0, 0.1))}
            for i in range(40)]
    spikes = [dict(m) for m in base]
    spikes[12]["loss"] = 50.0
    spikes[13]["loss"] = 2.9
    spikes[20]["grad_norm"] = 40.0
    spikes[27]["loss"] = float("nan")
    spikes[33]["grad_norm"] = float("inf")
    early = [{"loss": 2.0, "grad_norm": 1.0}] * 3 + [{"loss": 1000.0, "grad_norm": 1e6}] + base[:8]
    partial = [{"loss": m["loss"]} if i % 3 else {"grad_norm": m["grad_norm"]} for i, m in enumerate(spikes)]
    return {"clean": base, "spikes": spikes, "early": early, "partial": partial}


@pytest.mark.parametrize("name", sorted(_sequences()))
@pytest.mark.parametrize("kw", [dict(), dict(anomaly_min_history=3, anomaly_window=4, loss_spike_factor=1.5,
                                             grad_spike_factor=2.0)])
def test_detector_flags_what_jax_flags(name, kw):
    seq = _sequences()[name]
    jdet = janomaly.AnomalyDetector(jcfg.ResilienceConfig(anomaly_detection=True, **kw))
    tdet = tanomaly.AnomalyDetector(tcfg.ResilienceConfig(anomaly_detection=True, **kw))
    for step, metrics in enumerate(seq, 1):
        want, got = jdet.observe(step, metrics), tdet.observe(step, metrics)
        if want is None:
            assert got is None, step
            continue
        assert got is not None, step
        w, g = want.as_event(), got.as_event()
        for key in ("event", "kind", "step", "value", "threshold"):
            assert (w[key] == g[key]) or (isinstance(w[key], float) and math.isnan(w[key]) and math.isnan(g[key]))
        if step == 20:
            jdet.reset()
            tdet.reset()


# ---------------------------------------------------------------- watchdog


def test_watchdog_fires_pauses_and_stays_quiet():
    codes, timeouts = [], []
    dog = StepWatchdog(0.2, on_timeout=lambda: timeouts.append(True), exit_fn=codes.append).start()
    try:
        time.sleep(0.4)
        assert not dog.fired  # not armed before the first heartbeat
        dog.heartbeat()
        dog.pause()
        time.sleep(0.5)  # a slow save: paused
        assert not dog.fired
        dog.resume()
        for _ in range(4):
            dog.heartbeat()
            time.sleep(0.05)
        assert not dog.fired
        deadline = time.monotonic() + 5.0
        while not dog.fired and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dog.fired and codes == [EXIT_WEDGED] and timeouts == [True]
    finally:
        dog.stop()
    with pytest.raises(ValueError):
        StepWatchdog(0.0)


def test_emergency_save_only_at_a_step_boundary(tmp_path):
    """The in-place optimizer: a save while a step is in flight would be
    torn, so the emergency path skips it and logs why; at a boundary it
    writes the completed step's state."""
    logger = _Records()
    t = _trainer(_tiny(tmp_path, train=dict(train_steps=3, checkpoint_interval=0, save_final=False)),
                 logger=logger)
    t.train()
    with t._boundary:
        t._at_boundary = False
    t._emergency_save()
    assert tckpt.latest_checkpoint(str(tmp_path / "ck")) is None
    assert logger.events("emergency_save_skipped")[-1]["why"] == "not at a step boundary"
    t._at_boundary = True
    t._emergency_save()
    assert tckpt.latest_checkpoint(str(tmp_path / "ck")).endswith("step-3")
    state, _ = tckpt.load_checkpoint(str(tmp_path / "ck" / "step-3"), t._state_template())
    for (_, a), (_, b) in zip(topt.tree_leaves(state), topt.tree_leaves(t.state)):
        assert torch.equal(a, b)


def test_emergency_save_keeps_the_completed_steps_frontier(tmp_path):
    """The watchdog may fire while the loop draws the next step's batch (a
    stuck host-to-device copy): the save is still the completed step's, and
    so is its data frontier, not one batch past it."""
    logger = _Records()
    t = _trainer(_tiny(tmp_path, train=dict(train_steps=4, checkpoint_interval=0, save_final=False),
                       **{"data.prefetch": 0}), logger=logger)
    put, frontiers = t._put, []

    def stuck_put(batch):
        frontiers.append(json.loads(json.dumps(t.train_iterator.state())))
        if len(frontiers) == 4:  # step 4's batch is drawn, step 3 is complete
            t._emergency_save()
        return put(batch)

    t._put = stuck_put
    t.train()
    assert logger.events("emergency_checkpoint")[-1]["step"] == 3
    _, extra = tckpt.load_checkpoint(str(tmp_path / "ck" / "step-3"), t._state_template())
    assert extra["data_rng"] == frontiers[2] != frontiers[3]


# ------------------------------------------------------- restore_latest


@pytest.fixture(scope="module")
def two_checkpoints(tmp_path_factory):
    """A tiny run's step-4 and step-8 checkpoints."""
    tmp = tmp_path_factory.mktemp("two")
    cfg = _tiny(tmp, train=dict(train_steps=8, save_final=False))
    _trainer(cfg).train()
    assert sorted(tckpt._list_steps(str(tmp / "ck"))) == [4, 8]
    return cfg, tmp / "ck"


def _corrupt(ckdir, how):
    if how == "truncated_leaf":
        tfaults.truncate_leaf(str(ckdir / "step-8"))
    elif how == "missing_metadata":
        os.remove(ckdir / "step-8" / "metadata.json")
    elif how == "tmp_partial":
        os.makedirs(ckdir / "tmp-12")
        (ckdir / "tmp-12" / "half_written.npy").write_bytes(b"\x93NUMPY garbage")
    elif how == "all_corrupt":
        for step in (4, 8):
            os.remove(ckdir / f"step-{step}" / "metadata.json")


@pytest.mark.parametrize("how,before,want", [
    ("truncated_leaf", None, 4), ("missing_metadata", None, 4), ("tmp_partial", None, 8),
    ("all_corrupt", None, None), ("intact", 8, 4), ("intact", 4, None),
])
def test_restore_latest_falls_back_as_jax_does(two_checkpoints, tmp_path, how, before, want):
    cfg, src = two_checkpoints
    ckdir = tmp_path / "ck"
    import shutil

    shutil.copytree(src, ckdir)
    _corrupt(ckdir, how)
    jc = jcfg.get_preset("tiny").with_overrides({"model.compute_dtype": "float32"})
    jtemplate = jax.eval_shape(lambda: jts.init_train_state(jc, jax.random.key(0)))
    skipped_j, skipped_t = [], []
    jgot = jckpt.restore_latest(str(ckdir), jtemplate, before_step=before,
                                on_skip=lambda p, e: skipped_j.append(os.path.basename(p)))
    _corrupt(ckdir, how) if how == "tmp_partial" else None  # JAX's restore collected the partial
    t = _trainer(cfg, logger=_Records())
    tgot = tckpt.restore_latest(str(ckdir), t._state_template(), before_step=before, loader=t._checkpoint_loader,
                                on_skip=lambda p, e: skipped_t.append(os.path.basename(p)))
    assert (jgot and jgot[2]) == (tgot and tgot[2]) == want
    assert skipped_t == skipped_j
    assert not (ckdir / "tmp-12").exists()
    if want is not None:  # the same leaves, bit for bit
        jleaves = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                   for p, v in jax.tree_util.tree_leaves_with_path(jgot[0])}
        for path, leaf in topt.tree_leaves(tgot[0]):
            np.testing.assert_array_equal(leaf.numpy(), jleaves["/".join(path)])


def test_trainer_refuses_a_lineage_with_no_loadable_checkpoint(two_checkpoints, tmp_path):
    cfg, src = two_checkpoints
    import shutil

    shutil.copytree(src, tmp_path / "ck")
    _corrupt(tmp_path / "ck", "all_corrupt")
    with pytest.raises(RuntimeError, match="none are loadable"):
        _trainer(cfg.with_overrides({"train.checkpoint_dir": str(tmp_path / "ck")}), resume=True)


# ------------------------------------------------- the port against JAX


def _tree(seed=0):
    jc = jcfg.ModelConfig(**MODEL)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, spec: ((1.0 if path[-1].key == "scale" else 0.0)
                            + rng.normal(0, 0.05, spec.shape)).astype(np.float32), layout)


def test_nan_rollback_matches_the_jax_trainer(tmp_path):
    """One init, one token file (both packages' native batchers), ``nan@5``:
    both flag step 6, restore step 4, skip 2 batches, finish at 12 with
    every logged loss within the train-step bar."""
    tokens = np.random.default_rng(3).integers(0, MODEL["vocab_size"], 20_000, dtype=np.uint16)
    data = tmp_path / "train.bin"
    tokens.tofile(data)
    over = {"train.batch_size": 8, "train.lr": 1e-3, "train.train_steps": 12, "train.warmup_frac": 0.2,
            "train.checkpoint_interval": 4, "train.log_interval": 2, "train.eval_interval": 0,
            "data.train_path": str(data), "data.val_path": str(data), "resilience.anomaly_detection": True,
            "resilience.faults": "nan@5"}
    jc = jcfg.Config(model=jcfg.ModelConfig(**MODEL)).with_overrides(
        {**over, "train.checkpoint_dir": str(tmp_path / "jck")})
    tc = tcfg.Config(model=tcfg.ModelConfig(**MODEL)).with_overrides(
        {**over, "train.checkpoint_dir": str(tmp_path / "tck")})
    tree = _tree(1)
    jlog, tlog = _Records(), _Records()
    jt = JTrainer(jc, resume=False, logger=jlog)
    jt.state = dict(jt.state, params=jax.tree.map(jnp.asarray, tree))
    tt = Trainer(tc, resume=False, logger=tlog, device="cpu")
    assert tt.sampler == "native" and type(jt.train_iterator).__name__ == "NativeBatchIterator"
    tt.state["params"] = bridge.params_from_numpy(tree, tc.model, device="cpu")
    tt.state["opt"] = topt.adamw_init(tt.state["params"])
    jt.train()
    tt.train()
    assert jt.exit_reason == tt.exit_reason == "completed"
    for kind, keys in (("anomaly_detected", ("kind", "step")),
                       ("rollback", ("kind", "from_step", "to_step", "skipped_batches", "budget_left")),
                       ("fault_injected", ("kind", "step"))):
        want = [{k: r[k] for k in keys} for r in jlog.events(kind)]
        assert want and [{k: r[k] for k in keys} for r in tlog.events(kind)] == want, kind
    assert [(r["from_step"], r["to_step"], r["skipped_batches"]) for r in tlog.events("rollback")] == [(6, 4, 2)]
    jl, tl = jlog.losses(), tlog.losses()
    assert [s for s, _ in tl] == [s for s, _ in jl] == [2, 4, 6, 6, 8, 10, 12]
    for (s, want), (_, got) in zip(jl, tl):
        if math.isnan(want):
            assert math.isnan(got), s
        else:
            assert abs(got - want) <= LOSS_RTOL * abs(want), (s, got, want)
    assert tt.train_iterator.state() == jt.train_iterator.state()  # the same data frontier


# ------------------------------------------------------ in-process drills


def test_nan_rollback_restores_skips_and_completes(tmp_path):
    """NaN after step 9 -> detected at the step-10 boundary -> step 8
    restored, 2 batches skipped -> step 16 with finite losses; a run resumed
    from step 16 never fires ``nan@9`` again."""
    logger = _Records()
    cfg = _tiny(tmp_path, res=dict(faults="nan@9"))
    t = _trainer(cfg, logger=logger)
    final = t.train()
    assert t.exit_reason == "completed" and math.isfinite(final["loss"])
    assert [(r["from_step"], r["to_step"], r["skipped_batches"]) for r in logger.events("rollback")] == [(10, 8, 2)]
    assert logger.events("anomaly_detected")[0]["kind"] == "nan"
    assert logger.losses()[-1][0] == 16 and all(math.isfinite(x) for s, x in logger.losses() if s > 10)
    more = _Records()
    t2 = _trainer(cfg.with_overrides({"train.train_steps": 20}), resume=True, logger=more)
    assert t2.start_step == 16
    assert math.isfinite(t2.train()["loss"]) and not more.events("fault_injected")


@pytest.mark.parametrize("res,train,reason,newest", [
    (dict(faults="nan@9", rollback_budget=0), dict(train_steps=14), "anomaly_budget", 8),
    (dict(faults="nan@3"), dict(checkpoint_interval=0), "anomaly_no_checkpoint", None),
])
def test_anomaly_stops_the_run(tmp_path, res, train, reason, newest):
    """Budget spent, or nothing to restore: the run stops, and the poisoned
    state is never saved as a final checkpoint."""
    logger = _Records()
    t = _trainer(_tiny(tmp_path, train=train, res=res), logger=logger)
    t.train()
    assert t.exit_reason == reason
    steps = tckpt._list_steps(str(tmp_path / "ck"))
    assert (max(steps) if steps else None) == newest
    if newest is not None:
        assert logger.events("rollback_budget_exhausted")
        assert _trainer(_tiny(tmp_path, train=train, res=res), resume=True).start_step == newest


def test_sigterm_checkpoints_at_the_next_log_boundary(tmp_path):
    t = _trainer(_tiny(tmp_path, res=dict(faults="sigterm@5")))
    t.train()
    assert t.exit_reason == "preempted"
    assert max(tckpt._list_steps(str(tmp_path / "ck"))) == 6
    assert signal.getsignal(signal.SIGTERM) is not None  # the previous handler is back


def test_truncated_checkpoint_then_resume(tmp_path):
    """``ckpt_truncate@8`` tears step-8 right after it lands (9 steps, no
    final save); a resume digs back to step 4 and trains on."""
    logger = _Records()
    cfg = _tiny(tmp_path, train=dict(train_steps=9, save_final=False), res=dict(faults="ckpt_truncate@8"))
    _trainer(cfg, logger=logger).train()
    assert [r["kind"] for r in logger.events("fault_injected")] == ["ckpt_truncate"]
    resumed_log = _Records()
    t2 = _trainer(cfg.with_overrides({"train.train_steps": 12, "resilience.faults": ""}), resume=True,
                  logger=resumed_log)
    assert t2.start_step == 4 and resumed_log.events("checkpoint_skipped")[0]["path"].endswith("step-8")
    t2.train()
    assert t2.exit_reason == "completed"


def test_train_cli_return_codes(tmp_path):
    """43 after a SIGTERM stop, 44 after a spent budget; 0 returns the final
    metrics. (45 is the watchdog's own ``os._exit``: the next test.)"""
    base = ["--preset", "tiny", "--data", "synthetic", "--device", "cpu", "--steps", "10", "--override",
            "train.log_interval=2", "train.checkpoint_interval=4", "train.eval_interval=0",
            "model.compute_dtype=float32", "resilience.anomaly_detection=True"]
    for faults, budget, code in (("sigterm@3", 3, EXIT_PREEMPTED), ("nan@5", 0, EXIT_ANOMALY)):
        with pytest.raises(SystemExit) as e:
            tcli.main(base + [f"train.checkpoint_dir={tmp_path / faults}", f"resilience.faults={faults}",
                              f"resilience.rollback_budget={budget}"])
        assert e.value.code == code
    final = tcli.main(base + [f"train.checkpoint_dir={tmp_path / 'clean'}"])
    assert final["loss"] > 0


# ------------------------------------------------------- subprocess drills


def _run(cmd, timeout=300):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    return proc.returncode, proc.stdout + proc.stderr


def _cli(ckdir, *overrides, steps=16):
    return [sys.executable, "-m", "pretraining_llm_tpu_torch.train", "--preset", "tiny", "--data", "synthetic",
            "--device", "cpu", "--override", f"train.train_steps={steps}", f"train.checkpoint_dir={ckdir}",
            "train.log_interval=2", "train.checkpoint_interval=4", "train.eval_interval=0",
            "model.compute_dtype=float32", *overrides]


def test_watchdog_exits_wedged_with_an_emergency_checkpoint(tmp_path):
    ckdir = tmp_path / "ck"
    rc, out = _run(_cli(ckdir, "resilience.watchdog_timeout_s=3.0", "resilience.faults=hang@6"))
    assert rc == EXIT_WEDGED, out[-3000:]
    assert 6 in tckpt._list_steps(str(ckdir)), out[-3000:]
    assert "step watchdog" in out and "_fire_hang" in out  # the thread stacks


def test_supervisor_relaunches_a_drilled_run_to_the_clean_state(tmp_path):
    """SIGTERM after step 5 and a hang after step 10 under the supervisor:
    children exit 43, 45, 0 and the step-16 state is the clean run's bit
    for bit."""
    clean = _trainer(_tiny(tmp_path / "clean", train=dict(checkpoint_interval=4, log_interval=2)))
    clean.train()
    ckdir = tmp_path / "drilled"
    rc, out = _run([sys.executable, "-m", "pretraining_llm_tpu_torch.supervisor", "--backoff-base", "0.05", "--",
                    *_cli(ckdir, "resilience.watchdog_timeout_s=3.0", "resilience.faults=sigterm@5,hang@10")])
    assert rc == 0, out[-3000:]
    sup = [json.loads(line) for line in out.splitlines() if line.startswith('{"supervisor"')]
    assert [r["rc"] for r in sup if r["event"] == "exit"] == [EXIT_PREEMPTED, EXIT_WEDGED, 0]
    assert [r["why"] for r in sup if r["event"] == "relaunch"] == ["preempted", "wedged"]
    state, extra = tckpt.load_checkpoint(str(ckdir / "step-16"), clean._state_template())
    for (path, a), (_, b) in zip(topt.tree_leaves(state), topt.tree_leaves(clean.state)):
        assert torch.equal(a, b), path


def _supervise(*child, args=("--backoff-base", "0.05"), timeout=60):
    return subprocess.run([sys.executable, "-m", "pretraining_llm_tpu_torch.supervisor", *args, "--",
                           sys.executable, "-c", *child], cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _sup_events(proc):
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"supervisor"')]


@pytest.mark.parametrize("code,args,rc,launches", [
    (EXIT_ANOMALY, ("--max-restarts", "5", "--backoff-base", "0.05"), EXIT_ANOMALY, 1),  # fatal
    (7, ("--max-restarts", "2", "--backoff-base", "0.05"), 7, 3),  # crash budget
    (EXIT_WEDGED, ("--max-restarts", "2", "--backoff-base", "0.05", "--healthy-secs", "0"), EXIT_WEDGED, 3),
])
def test_supervisor_policy(code, args, rc, launches):
    """The JAX supervisor's policy: 44 is never relaunched, a crash spends
    the restart budget, and a wedge never resets the failure count."""
    proc = _supervise(f"import sys; sys.exit({code})", args=args)
    assert proc.returncode == rc
    events = [r["event"] for r in _sup_events(proc)]
    assert events.count("launch") == launches and "failure_count_reset" not in events


def test_supervisor_forwards_sigterm_and_does_not_relaunch(tmp_path):
    ready = tmp_path / "ready"
    child = ("import pathlib, signal, sys, time; signal.signal(signal.SIGTERM, lambda *a: sys.exit(43)); "
             f"pathlib.Path({str(ready)!r}).write_text('r'); time.sleep(120)")
    proc = subprocess.Popen([sys.executable, "-m", "pretraining_llm_tpu_torch.supervisor", "--backoff-base", "0.05",
                             "--", sys.executable, "-c", child], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30.0
        while not ready.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ready.exists()
        os.kill(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == EXIT_PREEMPTED
    events = [json.loads(line)["event"] for line in out.splitlines() if line.startswith('{"supervisor"')]
    assert events.count("launch") == 1 and "terminated" in events

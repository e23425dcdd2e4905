"""Shared set-up of the port's process-replica tests
(``test_torch_port_process_fleet.py``, ``test_torch_port_multihost_fleet.py``).

The JAX package's tiny preset at fp32 with seeded numpy weights (std 0.3)
is written as a JAX checkpoint, which the port's workers load
(``"model_path"`` in the worker spec, on the CPU); the JAX package's
``ServingEngine`` on the same weights, in this process, gives the stream
every fleet run must reproduce. Each worker is a real process on one
torch thread (``OMP_NUM_THREADS=1`` reaches it through the environment
RemoteReplica copies), started with short spawn and RPC timeouts; every
wait is bounded and every process is killed in a finalizer.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.generation import serving as jserving
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.training import checkpoint as jckpt

ROOT = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jcfg.get_preset("tiny").model, compute_dtype="float32")
WAIT = 120  # seconds any one result(), join() or poll may take
SPAWN_S = 120.0  # a worker's start: the torch import, the checkpoint, the engine
KV_KW = {"prefix_cache": True, "kv_checksum": True}
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@functools.lru_cache(maxsize=None)
def jax_params():
    layout = jax.eval_shape(functools.partial(jtf.init_params, JCFG), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return jnp.asarray((base + rng.normal(0, 0.3, spec.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, layout)


def write_checkpoint(root: Path) -> str:
    """The weights as a JAX checkpoint (step 1) under ``root``."""
    config = jcfg.Config(model=JCFG, data=jcfg.DataConfig(tokenizer_name="byte"))
    jckpt.save_checkpoint(str(root), 1, {"params": jax_params()},
                          extra={"step": 1, "config": dataclasses.asdict(config)})
    return str(root)


def engine_kw(**kw):
    return {"max_batch": 2, "n_blocks": 24, "block_size": 8, "steps_per_sched": 4, "pipeline_depth": 2, **kw}


def prompts(n, lengths=(5, 9, 14, 7, 11, 3, 16, 6)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, JCFG.vocab_size, size=int(lengths[i % len(lengths)])).tolist() for i in range(n)]


def shared_prefix_prompts(n=3, shared=12, tail=3, seed=42):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, JCFG.vocab_size, size=shared).tolist()
    return [prefix + rng.integers(0, JCFG.vocab_size, size=tail).tolist() for _ in range(n)]


def distinct_prompts(n=3, length=13, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, size=length).tolist() for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(key):
    prompt_list, n_new, kw = json.loads(key)
    eng = jserving.ServingEngine(jax_params(), JCFG, temperature=0.0, **engine_kw(**kw))
    rids = {eng.submit(p, n_new): i for i, p in enumerate(prompt_list)}
    return {rids[rid]: [int(t) for t in toks] for rid, toks in eng.run().items()}


def undisturbed(prompt_list, n_new, **kw):
    """The JAX package's in-process engine on the same weights and
    scheduling: the stream any disturbed fleet run must reproduce."""
    return _reference(json.dumps([prompt_list, n_new, dict(sorted(kw.items()))]))


def worker_spec(model_path, **engine_extra):
    return {"model_path": model_path, "device": "cpu", "engine": {**engine_kw(**engine_extra), "temperature": 0.0},
            "admission": {"max_queue_depth": 8}}


def start_all(reps):
    """Start the replicas' workers side by side (``Router.start`` then skips
    the launched ones); re-raise the first start's failure."""
    errors = []

    def one(rep):
        try:
            rep.start()
        except Exception as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    threads = [threading.Thread(target=one, args=(rep,), daemon=True) for rep in reps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SPAWN_S + 30)
    if errors:
        for rep in reps:
            kill_worker(rep)
        raise errors[0]
    return reps


def kill_worker(rep):
    proc = getattr(rep, "proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def worker_env():
    env = dict(os.environ, **WORKER_ENV)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def spawn_listen_worker(model_path, token="", **engine_extra):
    """A pre-spawned worker (``--listen 127.0.0.1:0``): (proc, "host:port")
    once it announces its port."""
    cmd = [sys.executable, "-m", "pretraining_llm_tpu_torch.frontend.worker",
           "--spec-json", json.dumps(worker_spec(model_path, **engine_extra)), "--listen", "127.0.0.1:0"]
    if token:
        cmd += ["--token", token]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=None, env=worker_env(), cwd=ROOT)
    try:
        line = proc.stdout.readline()
        port = int(json.loads(line)["worker"]["port"])
    except Exception:
        proc.kill()
        raise
    return proc, f"127.0.0.1:{port}"


def kill_procs(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def wait_until(pred, timeout, msg):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(msg)

"""Checkpoints in the JAX package's format: one ``.npy`` per leaf and a
``metadata.json``, written atomically, with exact resume.

An own copy of the single-process part of ``pretraining_llm_tpu/training/
checkpoint.py``:

  - each state leaf is ``<dir>/step-<N>/<name>.npy``, named by its
    ``__``-joined path (``opt__mu__blocks__attn__wqkv``);
  - ``metadata.json`` holds ``format_version`` 2, the step, the leaf
    manifest (shape, dtype and a blake2b checksum of the bytes) and the
    caller's ``extra``; ``local.p0.json`` the per-process extra (the
    data-sampler RNG state);
  - writes go to ``tmp-<N>`` and are renamed to ``step-<N>``, so a killed
    run never leaves a half checkpoint visible; the latest ``keep`` steps
    are kept;
  - ``restore_latest`` falls back past a corrupt newest step (a truncated
    leaf, a missing ``metadata.json``), optionally only below a step, and
    collects ``tmp-<step>`` partials first;
  - ``AsyncCheckpointWriter`` copies the state to host memory at the step
    and writes it on a thread (``train.checkpoint_async``);
  - leaves are written, read and checksummed by a pool of up to
    ``IO_WORKERS`` threads (blake2b and file IO release the interpreter
    lock); each leaf is its own file, so the bytes do not depend on it.

A checkpoint written by the JAX trainer restores in the port and the
reverse: same names, same ``.npy`` bytes. A bf16 leaf is written as the
JAX package writes it (numpy has no bfloat16: the ``.npy`` holds raw
2-byte records, ``<V2``, and the manifest says ``bfloat16``); the checksum
covers the manifest's dtype name. Leaves load as CPU tensors.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.observability.spans import span as _span
from pretraining_llm_tpu_torch.training.optimizer import tree_leaves

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int32": torch.int32, "int64": torch.int64,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


IO_WORKERS = min(8, os.cpu_count() or 1)


def _map_leaves(fn: Callable[..., Any], items: Sequence[Tuple[Any, ...]]) -> List[Any]:
    """``[fn(*item) for item in items]``, in order, on the IO thread pool."""
    with ThreadPoolExecutor(IO_WORKERS) as pool:
        return list(pool.map(lambda item: fn(*item), items))


class IntegrityError(ValueError):
    """A checkpoint leaf whose bytes do not match its manifest checksum."""


def array_digest(arr: np.ndarray, dtype_name: Optional[str] = None) -> str:
    """Content checksum of a leaf, as ``resilience/integrity.py::
    array_digest``: blake2b-128 over the dtype name, the shape and the
    bytes. ``dtype_name`` overrides ``str(arr.dtype)`` (bf16 leaves, whose
    numpy dtype is raw ``<V2`` records)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update((dtype_name or str(arr.dtype)).encode())
    h.update(repr(arr.shape).encode())
    h.update(memoryview(arr.reshape(-1).view(np.uint8)))  # the bytes of tobytes(), not copied
    return h.hexdigest()


def _flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    """(name, leaf) in sorted-key order, the JAX flatten order."""
    return [("__".join(path), leaf) for path, leaf in tree_leaves(tree)]


def _unflatten(template: Any, leaves: Dict[str, Any], path: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path + (str(k),)) for k, v in template.items()}
    return leaves["__".join(path)]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array as written, dtype name of the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(tmp: str, name: str, leaf: Any) -> Dict[str, Any]:
    arr, dtype_name = _to_numpy(leaf)
    path = os.path.join(tmp, f"{name}.npy")
    if dtype_name == "bfloat16":
        # The header numpy writes for an ml_dtypes bfloat16 array: raw
        # little-endian 2-byte records.
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(path, arr)
    return {
        "name": name, "shape": list(arr.shape), "dtype": dtype_name, "sharded": False,
        "checksum": array_digest(arr, dtype_name),
    }


def save_checkpoint(
    directory: str, step: int, state: Any, *, extra: Optional[Dict[str, Any]] = None,
    local_extra: Optional[Dict[str, Any]] = None, keep: int = 3,
) -> str:
    """Write ``<directory>/step-<step>/`` atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with _span("checkpoint/write_leaves"):
        manifest = _map_leaves(lambda name, leaf: _save_leaf(tmp, name, leaf), _flatten_with_names(state))
    if local_extra:
        with open(os.path.join(tmp, "local.p0.json"), "w") as f:
            json.dump(local_extra, f)
    meta = {
        "step": int(step), "format_version": 2, "n_processes": 1,
        "manifest": manifest, "extra": extra or {},
    }
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step-{s}"), ignore_errors=True)


def _list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step-"):
            try:
                out.append(int(name.split("-", 1)[1]))
            except ValueError:
                continue
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = _list_steps(directory)
    return os.path.join(directory, f"step-{max(steps)}") if steps else None


def gc_partial(directory: str) -> List[str]:
    """Remove leftover ``tmp-<step>`` dirs (partial writes of a killed run)."""
    if not os.path.isdir(directory):
        return []
    removed = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("tmp-"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            removed.append(name)
    return removed


def restore_latest(
    directory: str, state_template: Any, *, before_step: Optional[int] = None,
    loader: Optional[Callable[[str, Any], Tuple[Any, Dict[str, Any]]]] = None,
    on_skip: Optional[Callable[[str, Exception], None]] = None,
) -> Optional[Tuple[Any, Dict[str, Any], int]]:
    """The newest loadable checkpoint as (state, extra, step), falling back
    past corrupt ones (each reported to ``on_skip``); None when none
    loads. ``before_step`` tries only steps below it (a rollback digging
    past a poisoned checkpoint); ``loader(path, template)`` defaults to
    ``load_checkpoint``."""
    gc_partial(directory)
    load = loader or load_checkpoint
    steps = sorted(_list_steps(directory), reverse=True)
    if before_step is not None:
        steps = [s for s in steps if s < before_step]
    for step in steps:
        path = os.path.join(directory, f"step-{step}")
        try:
            state, extra = load(path, state_template)
        except Exception as e:  # corrupt/truncated/missing pieces: fall back
            if on_skip is not None:
                on_skip(path, e)
            continue
        return state, extra, step
    return None


def _load_leaf(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    name = entry["name"]
    if entry.get("sharded"):
        raise NotImplementedError(
            f"leaf {name} of {path} is sharded across processes; multi-process "
            "checkpoints are not ported to PyTorch yet"
        )
    arr = np.load(os.path.join(path, f"{name}.npy"))
    dtype_name = entry.get("dtype", str(arr.dtype))
    expected = entry.get("checksum")
    if expected is not None and array_digest(arr, dtype_name) != expected:
        raise IntegrityError(f"checksum mismatch for {name} (corrupted checkpoint leaf)")
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    if dtype_name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint leaf {name}: unsupported dtype {dtype_name}")
    return torch.from_numpy(np.array(arr, copy=True))


def load_checkpoint(path: str, state_template: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore a tree shaped like ``state_template`` (tensors, or anything
    with a ``shape``) from ``path``. Returns (tree of CPU tensors, extra),
    with ``local.p0.json`` merged into extra."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    local_path = os.path.join(path, "local.p0.json")
    if os.path.exists(local_path):
        with open(local_path) as f:
            meta.setdefault("extra", {}).update(json.load(f))
    entries = {m["name"]: m for m in meta["manifest"]}
    flat = _flatten_with_names(state_template)
    missing = [n for n, _ in flat if n not in entries]
    if missing:
        raise ValueError(
            f"checkpoint {path} missing leaves: {missing[:5]} (+{max(0, len(missing) - 5)} more)"
        )
    leaves = {}
    with _span("checkpoint/load_leaves"):
        loaded = _map_leaves(lambda name: _load_leaf(path, entries[name]), [(name,) for name, _ in flat])
    for (name, tmpl), got in zip(flat, loaded):
        want = tuple(getattr(tmpl, "shape", np.shape(tmpl)))
        if tuple(got.shape) != want:
            raise ValueError(f"checkpoint leaf {name}: shape {tuple(got.shape)} != expected {want}")
        leaves[name] = got
    return _unflatten(state_template, leaves), meta.get("extra", {})


class AsyncCheckpointWriter:
    """``train.checkpoint_async``: ``save`` copies the state to host memory
    synchronously (the written values are exactly this step's, although the
    step updates the device state in place afterwards) and writes it on a
    background thread; ``join`` waits for the write in flight and raises
    ``RuntimeError`` from its error, so a failed write reaches the training
    loop at the next save or at the end of ``train``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, directory: str, step: int, state: Any, **kwargs: Any) -> None:
        host = _host_copy(state)
        self.join()  # one write at a time into the directory

        def write() -> None:
            try:
                save_checkpoint(directory, step, host, **kwargs)
            except BaseException as e:  # surfaced by join()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def idle(self, timeout: float) -> bool:
        """Wait up to ``timeout`` s for the write in flight; True when none
        is running (its error stays for ``join``)."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
        return thread is None or not thread.is_alive()

    def join(self) -> None:
        thread, self._thread = self._thread, None
        if thread is None:
            return
        thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err


def _host_copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree

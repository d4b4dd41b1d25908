"""Atomic, async checkpointing with resume, in the reference's on-disk
format (``repro.training.checkpoint``): a checkpoint written by either
package restores in the other.

Layout:
  <dir>/step_00000100/
      manifest.json        keys, shapes, dtypes, metadata, time
      arrays.npz           leaf arrays, keyed by flattened path
  <dir>/LATEST             text file containing "step_00000100" (atomic)

A key is the leaf's path joined by "/": dict keys, and the field names of
a ``NamedTuple`` (so an ``AdamWState`` under "opt" gives
``opt/mu/layers/attn/wk`` and ``opt/step``).  Leaves are written in the
order JAX flattens the same tree (dict keys sorted, tuple fields in
order).  numpy's npz cannot hold bfloat16, so such a leaf is stored as
uint16 with "bfloat16" in the manifest; the port encodes it through a
tensor view of the bits, so it needs no ``ml_dtypes``.  The trees are
nested dicts and ``NamedTuple``s of tensors.

Guarantees:
  * atomic: writes go to ``<dir>/.tmp.step_X`` then os.replace() — a crash
    mid-save never corrupts the latest checkpoint;
  * restartable: ``restore_latest`` finds LATEST (or scans) and rebuilds
    the exact tree (params, optimizer state), on the device of the tree
    it is given;
  * async: ``AsyncCheckpointer.save`` copies every leaf to host memory
    before it returns (so the next in-place optimizer update cannot race
    the write) and writes in a background thread;
  * bounded: ``keep`` newest checkpoints are retained, older ones GC'd.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, tensor) in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, path + (name,))
    else:
        yield "/".join(path), tree


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as npz can store it, and its dtype's name."""
    t = t.detach()
    on_host = t.device.type == "cpu"
    if t.dtype == torch.bfloat16:  # npz has no bfloat16: its bits, uint16
        a = t.view(torch.int16).cpu().numpy().view(np.uint16)
    else:
        a = t.cpu().numpy()
    # .cpu() of a host tensor is the tensor itself: copy, so that the
    # caller's next in-place update cannot change what is written
    return (np.array(a, copy=True) if on_host else a), \
        str(t.dtype).replace("torch.", "")


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored {arr.dtype} for a {dtype} leaf")
    return torch.from_numpy(arr)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _encode(leaf) for k, leaf in _walk(tree)}


def _write(ckpt_dir: str, step: int, flat, metadata: Optional[dict],
           keep: int, process_index: int = 0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp.{name}.{process_index}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "metadata": metadata or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX

    # atomic LATEST pointer
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *,
         metadata: Optional[dict] = None, keep: int = 3,
         process_index: int = 0) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    return _write(ckpt_dir, step, _flatten(tree), metadata, keep,
                  process_index)


class AsyncCheckpointer:
    """Snapshot-then-write-in-background; at most one write in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()
        flat = _flatten(tree)  # host copies, taken before this returns

        def _run():
            try:
                _write(self.ckpt_dir, step, flat, metadata, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, ValueError, IndexError):
        steps = sorted(d for d in os.listdir(ckpt_dir)
                       if d.startswith("step_")) if os.path.isdir(ckpt_dir) \
            else []
        return int(steps[-1].split("_")[1]) if steps else None


def _rebuild(like, flat, path: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, flat, path + (name,))
                            for name, v in zip(like._fields, like)))
    key = "/".join(path)
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    t = flat[key]
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: stored shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(like.device)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Rebuild a tree with the same structure as ``like``: tensor leaves of
    the stored dtypes on the devices of ``like``'s leaves."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir, step)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: _decode(z[k], manifest["dtypes"][k]) for k in z.files}
    return _rebuild(like, flat)


def restore_latest(ckpt_dir: str, like: Any) -> Tuple[Optional[int], Any]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None, like
    return step, restore(ckpt_dir, step, like)


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)

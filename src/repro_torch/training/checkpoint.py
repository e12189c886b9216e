"""Fault-tolerant checkpointing: atomic, optionally asynchronous (port of
``src/repro/training/checkpoint.py``, same on-disk layout).

Layout:  <dir>/step_<N>/
            manifest.json     — step, leaf count, tree description, extra
            <idx>.npy         — one file per leaf, in JAX's flattening order
         <dir>/LATEST         — atomic pointer (write-temp + rename)

A tree is nested dicts (keys taken in sorted order, as
``jax.tree_util.tree_flatten`` takes them), tuples and lists, with tensors
or numpy arrays as leaves, so a tree laid out like the reference's
``(params, opt_state)`` (:func:`repro_torch.models.lm.params_to_jax`) is
written and read leaf for leaf as the reference writes and reads it, and
either package resumes the other's checkpoint.  bf16 leaves are written
as f32 (exact; a restore casts to the target's dtype, as the reference's
does).

Writes go to ``step_<N>.tmp`` and are renamed only after fsync, so a crash
mid-write never corrupts the restore point.  :class:`AsyncCheckpointer`
copies the tree to the host synchronously and writes it to disk on a
thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``
    (consumed)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return leaves.pop(0)


def _describe(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(s) for s in tree)
        return f"({inner},)" if isinstance(tree, tuple) and len(tree) == 1 else (
            f"({inner})" if isinstance(tree, tuple) else f"[{inner}]")
    return "*"


def to_host(tree: Any) -> Any:
    """The tree with every tensor leaf copied to a host numpy array (bf16 as
    f32); numpy leaves and numbers are kept."""
    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            return leaf.cpu().numpy()
        return np.asarray(leaf)
    return _unflatten(tree, [host(leaf) for leaf in _flatten(tree)])


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[Dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = _flatten(to_host(tree))
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": f"PyTreeDef({_describe(tree)})", "extra": extra or {}}
    for i, leaf in enumerate(leaves):
        np.save(tmp / f"{i}.npy", leaf)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync directory entries then atomic rename
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    latest_tmp = ckpt_dir / "LATEST.tmp"
    latest_tmp.write_text(str(step))
    latest_tmp.rename(ckpt_dir / "LATEST")
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    try:
        step = int(p.read_text().strip())
    except ValueError:
        return None
    return step if (Path(ckpt_dir) / f"step_{step}").exists() else None


def _torch_dtype(ref) -> torch.dtype:
    if isinstance(ref, torch.Tensor):
        return ref.dtype
    return torch.from_numpy(np.empty(0, dtype=ref.dtype)).dtype


def restore(ckpt_dir: str | Path, tree_like: Any,
            step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like``, whose leaves give the
    shape and dtype (tensors, meta tensors included, or numpy arrays):
    leaf count and shapes are validated, each leaf becomes a tensor of the
    target's dtype on its device (the CPU for numpy or meta targets)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    refs = _flatten(tree_like)
    if manifest["n_leaves"] != len(refs):
        raise ValueError(f"leaf count mismatch: ckpt {manifest['n_leaves']} "
                         f"vs target {len(refs)}")
    new_leaves = []
    for i, ref in enumerate(refs):
        arr = np.load(d / f"{i}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(ref.shape)}")
        dev = ref.device if isinstance(ref, torch.Tensor) and ref.device.type != "meta" \
            else torch.device("cpu")
        new_leaves.append(torch.from_numpy(np.array(arr, order="C", copy=True))
                          .to(device=dev, dtype=_torch_dtype(ref)))
    return _unflatten(tree_like, new_leaves), step, manifest.get("extra", {})


class AsyncCheckpointer:
    """Copy to the host synchronously, write to disk on a background thread."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()                               # one in-flight write at a time
        host_tree = to_host(tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001  (re-raised by wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.ckpt_dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s}", ignore_errors=True)

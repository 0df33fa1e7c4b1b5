"""Checkpoints of tensor trees: async writer, atomic commit, restore onto
any device (port of ``repro/checkpoint/store.py``, same on-disk layout, so
each package reads the other's steps).

Layout (one directory per step):
    ckpt_dir/step_00000123.tmp/   — being written (never restored from)
    ckpt_dir/step_00000123/       — renamed into place once complete
        manifest.json             — every leaf's shape and dtype, the step
        meta.json                 — optional JSON, committed with the leaves
        <leaf-path>.npy           — one file per leaf, "/" written as "__"

A tree is nested dicts (keys in sorted order), NamedTuples (field order)
and lists or tuples (index order); a leaf is a tensor, a numpy array or a
scalar.  ``save`` copies every tensor to host memory before it returns,
so a writer thread (``blocking=False``) never races the live tensors.  A
crash mid-write leaves only a ``.tmp`` directory, which ``latest_step``
and ``restore`` never take.  ``restore`` places each leaf on ``device``,
or on the device of the template's leaf where that is a tensor (the
counterpart of the JAX package's ``shardings``): a snapshot written on
one device count restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _join(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def _is_leaf(x) -> bool:
    """Arrays, tensors and (shape, dtype) records are leaves."""
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _flatten(tree, prefix=""):
    out = {}
    if _is_leaf(tree):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], _join(prefix, k)))
    elif hasattr(tree, "_fields"):                       # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), _join(prefix, k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, _join(prefix, i)))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if _is_leaf(template):
        return flat[prefix]
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, _join(prefix, k))
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, _join(prefix, k))
            for k in template._fields])
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten_into(v, flat, _join(prefix, i))
            for i, v in enumerate(template))
    return flat[prefix]


def _leaf_file(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def to_host(leaf) -> np.ndarray:
    """One leaf as a numpy array of its own (a copy in host memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True,
         meta: Optional[dict] = None) -> Optional[threading.Thread]:
    """Write step ``step`` of ``tree``; with ``blocking=False`` the files
    are written on a thread, which is returned.  ``meta`` (JSON) is
    written as ``meta.json`` inside the step directory, so it commits
    with the leaves: the campaign service keeps its job table there and
    never sees arrays without the records that read them."""
    host = {k: to_host(v) for k, v in _flatten(tree).items()}

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, v in host.items():
            np.save(os.path.join(tmp, _leaf_file(k)), v)
            manifest["leaves"][k] = {"shape": list(v.shape),
                                     "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if meta is not None:
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                            # the commit

    if blocking:
        write()
        return None
    th = threading.Thread(target=write, daemon=False)
    th.start()
    return th


def load_meta(ckpt_dir: str, step: int) -> Optional[dict]:
    """The ``meta.json`` committed with ``step`` (None if absent)."""
    p = os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step: ``.tmp`` directories and directories
    without a ``manifest.json`` are not taken."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in latest_candidates(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, f"step_{s:08d}",
                                            "manifest.json"))]
    return max(steps) if steps else None


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def restore(ckpt_dir: str, step: int, template: Any, device=None) -> Any:
    """Load step ``step`` into ``template``'s structure.  A template leaf
    gives the shape and dtype (a tensor, a numpy array, or anything with
    ``shape`` and ``dtype``, numpy or torch); a leaf is cast to it.  Each
    leaf is a tensor on ``device``, or, with ``device`` None, on the
    template leaf's device where it is a tensor and the CPU otherwise.
    uint32 leaves (the JAX package's keys) are widened to int64 first, as
    ``convert.tensor`` does."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _flatten(template)
    missing = set(flat_t) - set(manifest["leaves"])
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves: "
                         f"{sorted(missing)[:5]} ...")
    flat = {}
    for k, t in flat_t.items():
        arr = np.load(os.path.join(d, _leaf_file(k)))
        want = tuple(getattr(t, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {want}")
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        dt = getattr(t, "dtype", None)
        dt = (_torch_dtype(arr.dtype) if dt is None
              else dt if isinstance(dt, torch.dtype) else _torch_dtype(dt))
        where = device if device is not None else (
            t.device if isinstance(t, torch.Tensor) else "cpu")
        # ascontiguousarray makes a 0-d leaf 1-d: reshape it back
        flat[k] = torch.from_numpy(
            np.ascontiguousarray(arr).reshape(arr.shape)).to(
            device=where, dtype=dt)
    return _unflatten_into(template, flat)


def prune(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(latest_candidates(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_candidates(ckpt_dir: str):
    """Every step directory that is not a ``.tmp``."""
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]

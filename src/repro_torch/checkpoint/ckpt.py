"""Checkpointing (the port of ``repro/checkpoint/ckpt.py``), npz-based.

Layout, as the JAX package writes it: ``<dir>/step_<n>/shard_<host>.npz``
plus ``meta.json``; a save goes to a ``.tmp`` sibling and is renamed into
place, so a crash mid-save never corrupts the latest checkpoint.
``restore_latest`` walks the steps downward until one restores: the
restart path after a failure.

A state is nested dicts of tensors or numpy arrays, keyed in the npz by
their path joined with ``/``. numpy has no bfloat16 without
``ml_dtypes``, so a bf16 tensor is stored as its bits (``uint16``) and
restored bit for bit against the template's dtype. A restored tensor lands
on its template's device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = ""):
    """``(path, leaf)`` of a nested dict state, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, leaf, key: str):
    """``arr`` as ``leaf`` is: its type, dtype, shape and device."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(arr, dtype=np.asarray(leaf).dtype).reshape(np.shape(leaf))
    if leaf.dtype == torch.bfloat16:
        if arr.dtype != np.uint16:
            raise ValueError(f"checkpoint leaf {key}: bf16 is stored as uint16 bits, got {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
    return t.reshape(leaf.shape).to(leaf.device)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return _from_numpy(flat[key], template, key)


class CheckpointManager:
    """Periodic checkpointing with retention GC and crash-safe writes."""

    def __init__(self, directory: str, keep_last: int = 3, host_id: int = 0,
                 num_hosts: int = 1):
        self.dir = directory
        self.keep_last = keep_last
        self.host_id = host_id
        self.num_hosts = num_hosts
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra_meta: Optional[Dict] = None):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **_flatten(state))
        if self.host_id == 0:
            meta = {"step": step, "num_hosts": self.num_hosts}
            meta.update(extra_meta or {})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        # single-host: rename is the commit point
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    # ------------------------------------------------------------------
    def restore(self, step: int, template: Any) -> Any:
        path = os.path.join(self.dir, f"step_{step:09d}", f"shard_{self.host_id}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat)

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """Returns (step, state) of the newest complete checkpoint, or
        (None, template) when none exists."""
        for step in reversed(self.list_steps()):
            try:
                return step, self.restore(step, template)
            except Exception:
                continue  # incomplete/corrupt: fall back to the previous one
        return None, template

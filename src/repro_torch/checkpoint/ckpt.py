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

Sharded states (``DTensor`` leaves, ``repro_torch.distributed``): a save
gathers every such leaf whole, a collective that every rank of the mesh
calls (were only the writer to gather, it would wait for the others
forever). Leaves are gathered one at a time and copied to the host, so a
card holds one leaf whole at a time; host 0 alone keeps them and writes
the whole state as ``shard_0.npz``, and the other ranks wait at a barrier
until it is in place. A restore reads
that file on every rank and lays each leaf out with its *template's*
placements, on the template's mesh, which may be another mesh than the
one that saved it (the elastic re-mesh restart).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import gather, is_distributed


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
    """``arr`` as ``leaf`` is: its type, dtype, shape and device, and a
    ``DTensor`` leaf's mesh and placements (this rank keeps its block)."""
    if is_distributed(leaf):
        from torch.distributed.tensor import distribute_tensor

        whole = _from_numpy(arr, torch.empty(leaf.shape, dtype=leaf.dtype, device="cpu"), key)
        return distribute_tensor(whole.to(leaf.device), leaf.device_mesh, leaf.placements,
                                 src_data_rank=None)
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
        sharded = any(is_distributed(leaf) for _, leaf in _leaves(state))
        if sharded:                     # every rank gathers; host 0 writes the whole
            flat = {}
            for key, leaf in _leaves(state):
                arr = _to_numpy(gather(leaf))
                if self.host_id == 0:
                    flat[key] = arr
            if self.host_id != 0:
                _barrier()
                return
        else:
            flat = _flatten(state)
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **flat)
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
        if sharded:
            _barrier()

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
        """The state saved at ``step``, laid out as ``template`` is; a
        sharded template restores host 0's whole state on every rank."""
        sharded = any(is_distributed(leaf) for _, leaf in _leaves(template))
        host = 0 if sharded else self.host_id
        path = os.path.join(self.dir, f"step_{step:09d}", f"shard_{host}.npz")
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


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()

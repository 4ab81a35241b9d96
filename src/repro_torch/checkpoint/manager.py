"""Checkpoint manager: tree save / restore with atomic commit, retention
and asynchronous writes — the port of `repro/checkpoint/manager.py`, the
restart substrate of the fault-tolerant loop.

The on-disk layout is the reference's: one directory per step,
`step_XXXXXXXXXX/`, holding
  * tree.json  — the step, the time and each leaf's path and dtype
  * arrays.npz — the leaves as `a0`, `a1`, … in tree order (dict keys
                 sorted, as a JAX pytree orders them)
numpy has no bfloat16, so a bf16 leaf is stored as its 16 bits (uint16) and
named "bfloat16" in tree.json: it restores bit for bit. A checkpoint is
committed by the atomic rename of `step_….tmp` to its final name, so a
crash mid-save never leaves a restorable partial one.

A tree is nested dicts, lists and tuples (NamedTuples such as the training
state) of tensors; None is an empty node, as in JAX. `restore` takes a
tree of the same structure (tensors, or `spec_like`'s specs) and puts each
leaf in that leaf's dtype on that leaf's device; with `shardings` (a tree
of `runtime.sharding.NamedSharding`) each leaf becomes a DTensor laid out
on that sharding's mesh, which may be another layout of cards than the one
that saved (elastic restore). A state of DTensors is saved whole: every
rank gathers each leaf (`full_tensor`, a collective) and rank 0 writes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, leaves, unflatten


@dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape, dtype and device: the target of a restore."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def spec_like(tree) -> Any:
    """The tree with each tensor replaced by its LeafSpec (the reference's
    ShapeDtypeStruct template, plus the device)."""
    return unflatten(tree, iter([LeafSpec(tuple(t.shape), t.dtype, t.device)
                                 for t in leaves(tree)]))


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor") and hasattr(t, "placements")


def _to_host(t: torch.Tensor) -> np.ndarray:
    if _is_dtensor(t):
        t = t.full_tensor()                      # a collective
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:                # its bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A leaf read from the npz (a fresh array) as a tensor, no copy."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None   # of the last write
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, block: bool = False):
        """Copy to host memory synchronously, write asynchronously (or
        before returning, with `block` or without `async_save`). A state of
        DTensors is gathered on every rank and written by rank 0 alone; a
        blocking save then returns on every rank once it is committed."""
        flat = flatten_with_paths(state)
        paths = [p for p, _ in flat]
        host = [_to_host(t) for _, t in flat]     # device → host (sync)
        dtypes = [str(t.dtype).replace("torch.", "") for _, t in flat]
        sharded = any(_is_dtensor(t) for _, t in flat)
        if sharded:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                if block or not self.async_save:
                    dist.barrier()
                return
        self.wait()
        t = threading.Thread(target=self._write, args=(step, paths, host,
                                                       dtypes))
        t.start()
        self._pending = t
        if block or not self.async_save:
            self.wait()
            if sharded:
                import torch.distributed as dist
                dist.barrier()

    def _write(self, step: int, paths: List[str], host, dtypes):
        try:
            self._commit(step, paths, host, dtypes)
        except Exception as e:          # re-raised by wait() in the caller
            self._error = e

    def _commit(self, step: int, paths: List[str], host, dtypes):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": h for i, h in enumerate(host)})
        meta = {"step": step, "time": time.time(),
                "leaves": [{"path": p, "dtype": d}
                           for p, d in zip(paths, dtypes)]}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic commit
        self._gc()

    def wait(self):
        """Wait for the pending write; raise what it raised, if anything
        (its checkpoint is then not committed)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """The checkpoint of `step` in the structure of `like` (tensors or
        LeafSpecs), each leaf in that leaf's dtype on its device; with
        `shardings` (a tree like `like` of NamedShardings) each leaf a
        DTensor holding this rank's shard on that sharding's mesh (every
        rank reads the file and cuts its own shard: no communication)."""
        final = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(final, "tree.json")) as f:
            meta = json.load(f)
        targets = leaves(like)
        if len(meta["leaves"]) != len(targets):
            raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                             f"target {len(targets)}")
        shards = (leaves(shardings) if shardings is not None
                  else [None] * len(targets))
        out = []
        with np.load(os.path.join(final, "arrays.npz")) as data:
            for i, (leaf, t, sh) in enumerate(zip(meta["leaves"], targets,
                                                  shards)):
                a = _from_host(data[f"a{i}"], leaf["dtype"])   # one at a time
                a = a.to(device=t.device, dtype=t.dtype)
                out.append(a if sh is None else sh.apply(a))
        return unflatten(like, iter(out))

    def restore_latest(self, like: Any, shardings: Any = None
                       ) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like, shardings)

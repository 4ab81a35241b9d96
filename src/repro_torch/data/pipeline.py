"""Token data pipeline — the port of `repro/data/pipeline.py`.

Two sources behind one interface, `batch(step, batch_size)` → int32 numpy
[batch_size, seq]:
  * SyntheticSource — deterministic pseudo-text (Zipfian tokens with a
    learnable bigram rule), a function of (seed, step) alone, so a restart
    replays the same batches with no data state; the reference's numpy
    generator, copied, so both packages give the same batches bit for bit.
  * MemmapSource — packed uint16/uint32 token files.

`DataPipeline` takes this process's slice of the global batch, prefetches
batches on a background thread and puts them on the model's device; under
an active process mesh (`runtime.sharding.use_mesh`) each array is laid out
by the `batch` rule as a DTensor, every rank keeping its rows.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime import sharding


class SyntheticSource:
    """Deterministic synthetic LM data with learnable structure."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        # zipfian unigrams
        base = rng.zipf(1.3, size=(batch_size, self.seq)).astype(np.int64)
        toks = (base - 1) % self.vocab
        # learnable bigram structure: token 2k+1 follows 2k
        follow = (toks + 1) % self.vocab
        mask = rng.random((batch_size, self.seq)) < 0.5
        shifted = np.roll(follow, 1, axis=1)
        toks = np.where(mask, shifted, toks)
        return toks.astype(np.int32)


class MemmapSource:
    """Packed token file: a flat array of token ids, read in windows of
    `seq_len` chosen by a generator seeded with the step."""

    def __init__(self, path: str, seq_len: int, dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq = seq_len
        self.n_windows = len(self.data) // seq_len

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng(step)
        idx = rng.integers(0, self.n_windows, size=batch_size)
        out = np.stack([self.data[i * self.seq:(i + 1) * self.seq]
                        for i in idx])
        return out.astype(np.int32)


class DataPipeline:
    """Batches from `start_step` on: this process's rows of each global
    batch (`extras`: {name: fn(step, local_batch) → array} adds inputs such
    as an encoder's frames), made `prefetch` ahead on a thread and moved to
    `device` (default the card) as tensors."""

    def __init__(self, source, global_batch: int, start_step: int = 0,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, extras: Optional[dict] = None,
                 device="cuda"):
        assert global_batch % process_count == 0
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.process_index = process_index
        self.step = start_step
        self.extras = extras or {}
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        toks = self.source.batch(step, self.global_batch)
        lo = self.process_index * self.local_batch
        batch = {"tokens": toks[lo:lo + self.local_batch]}
        for name, fn in self.extras.items():
            batch[name] = fn(step, self.local_batch)
        return batch

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._q.get()
        self.step += 1
        return {k: self._place(torch.as_tensor(v).to(self.device))
                for k, v in batch.items()}

    @staticmethod
    def _place(x: torch.Tensor):
        """`x` laid out by the `batch` rule on the active process mesh
        (a DTensor), or as it is without one."""
        return sharding.distribute(x, ("batch",) + (None,) * (x.dim() - 1))

    def close(self):
        self._stop.set()

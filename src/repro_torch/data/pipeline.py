"""Data pipeline: deterministic synthetic LM stream + threaded prefetch.

The counterpart of the JAX package's ``data/pipeline.py``.  The stream is a
seeded Markov-ish token process (so losses actually go *down* during
training — pure-uniform tokens would pin the loss at log V).  Batches are
resumable: the generator state is just (seed, step), checkpointed alongside
the model, so a restarted run replays the exact stream.  ``next_batch``
makes the same numpy calls in the same order as the JAX package's, so both
packages see equal batches.

``Prefetcher`` double-buffers host batch construction behind device compute
on a background thread (the host-side analogue of the §2.1 prefetchable
command queue).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.common import ArchCfg


class SyntheticTokens:
    """Deterministic, resumable synthetic token batches."""

    def __init__(self, cfg: ArchCfg, batch: int, seq_len: int, *,
                 seed: int = 0, step: int = 0) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = step
        # fixed per-seed Markov transition "template" to give structure
        rng = np.random.default_rng(seed)
        self._mod = min(cfg.vocab, 257)
        self._shift = rng.integers(1, self._mod - 1)

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg: ArchCfg, batch: int, seq_len: int,
                   state: dict) -> "SyntheticTokens":
        return cls(cfg, batch, seq_len, seed=int(state["seed"]),
                   step=int(state["step"]))

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        start = rng.integers(0, self._mod, size=(self.batch, 1))
        idx = np.arange(self.seq_len)[None, :]
        # affine-progression tokens: next token is predictable from previous
        tokens = ((start + idx * self._shift) % self._mod).astype(np.int32)
        noise = rng.random(size=tokens.shape) < 0.05
        tokens = np.where(noise,
                          rng.integers(0, self._mod, size=tokens.shape),
                          tokens).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((self.batch, 1), -1, np.int32)], 1)
        batch = {"tokens": tokens, "labels": labels}
        cfg = self.cfg
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(self.batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(
                size=(self.batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def make_batch_arrays(batch: dict, cfg: ArchCfg, device) -> dict:
    """Host numpy batch -> tensors on ``device``: integer arrays as int64
    (PyTorch's index dtype; the values are the JAX package's int32 ones),
    float arrays in the model's dtype."""
    out = {}
    for k, v in batch.items():
        dtype = torch.int64 if v.dtype.kind == "i" else cfg.dtype
        out[k] = torch.as_tensor(v).to(device=device, dtype=dtype)
    return out


class Prefetcher:
    """Background-thread double buffering of host batch construction."""

    def __init__(self, it: Iterator[dict], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except Exception as e:  # surface errors to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass

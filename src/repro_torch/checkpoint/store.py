"""Checkpoint/restart substrate for the fault-tolerant trainer.

The counterpart of the JAX package's ``checkpoint/store.py``, with the same
on-disk layout: ``<dir>/step_<8 digits>/`` holding ``tensors.npz`` (one
array per leaf, the leaf's path joined by ``__``) and ``manifest.json``
(step, extra, and per tensor its shape, dtype and CRC32).  A leaf's key is
its path through nested dicts (sorted keys, as ``jax.tree`` orders them)
or lists (the index), joined by ``/`` — so a checkpoint written by either
package restores in the other where the trees agree (the trainer writes
the JAX pytree's layout, see ``repro_torch.weights``).

  * **integrity** — every tensor is CRC32-checksummed into the manifest; a
    corrupted/truncated file is *detected* at restore, never silently
    loaded;
  * **atomicity** — writes go to a temp dir + os.rename, so a node dying
    mid-save can never leave a half-written checkpoint that masquerades as
    valid;
  * **async** — ``save_async`` snapshots every tensor to host memory, then
    writes on a background thread off the training path; ``wait()`` joins
    before the next save or exit.

bf16 leaves are stored as their uint16 bits with dtype ``bfloat16`` in the
manifest (the CRC covers the same bytes JAX's ``ml_dtypes`` array holds);
the loader reads either storage.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken from iterator ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def to_host(x) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 as uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.array(x)


def _dtype_name(x, a: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def save_checkpoint(directory: str, step: int, tree, *, extra: dict | None
                    = None) -> str:
    """Atomic synchronous save.  Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for path, leaf in _leaves(tree):
        k = _key(path)
        arrays[k] = to_host(leaf)
        dtypes[k] = _dtype_name(leaf, arrays[k])
    manifest = {"step": int(step), "extra": extra or {}, "tensors": {}}
    for k, a in arrays.items():
        manifest["tensors"][k] = {
            "shape": list(a.shape), "dtype": dtypes[k],
            "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
        }
    np.savez(os.path.join(tmp, "tensors.npz"),
             **{k.replace("/", "__"): a for k, a in arrays.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _as_leaf(a: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    """A stored array as a CPU tensor, in ``like``'s dtype when the
    template leaf is a tensor."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(like.dtype) if isinstance(like, torch.Tensor) else t


def load_checkpoint(directory: str, step: int | None = None, *,
                    template=None):
    """Verified restore.  Returns (tree_or_flatdict, extra).

    With ``template`` (nested dicts/lists of like-structured leaves) the
    result has the template's structure, each leaf a CPU tensor with the
    stored shape (in the template leaf's dtype where that is a tensor);
    without it a flat {path: numpy array} dict.
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "tensors.npz")) as z:
        arrays = {k.replace("__", "/"): z[k] for k in z.files}
    for k, meta in manifest["tensors"].items():
        if k not in arrays:
            raise ValueError(f"checkpoint missing tensor {k}")
        a = arrays[k]
        stored = "bfloat16" if meta["dtype"] == "bfloat16" \
            and a.dtype.itemsize == 2 else str(a.dtype)
        if list(a.shape) != meta["shape"] or stored != meta["dtype"]:
            raise ValueError(f"checkpoint tensor {k} shape/dtype mismatch")
        if zlib.crc32(np.ascontiguousarray(a).tobytes()) != meta["crc32"]:
            raise ValueError(f"checkpoint tensor {k} failed CRC check")
    if template is None:
        return arrays, manifest["extra"]
    flat_t = [(_key(p), leaf) for p, leaf in _leaves(template)]
    missing = {k for k, _ in flat_t} - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing tensors: {sorted(missing)[:5]}")
    values = iter([_as_leaf(arrays[k], manifest["tensors"][k]["dtype"], leaf)
                   for k, leaf in flat_t])
    return _rebuild(template, values), manifest["extra"]


class CheckpointStore:
    """Async, GC'd checkpoint manager for the trainer."""

    def __init__(self, directory: str, *, keep_last: int = 3) -> None:
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree, *, extra: dict | None = None):
        self.wait()
        # snapshot off the device before the thread starts: the trainer
        # updates its tensors in place on the next step
        host_tree = _rebuild(tree, iter([
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for _, leaf in _leaves(tree)]))

        def run():
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:  # pragma: no cover - surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template):
        return load_checkpoint(self.directory, template=template)


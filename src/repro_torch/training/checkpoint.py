"""Checkpoints (the port's ``repro.training.checkpoint``): atomic, resumable,
and in the reference's on-disk format, so a checkpoint written by either
package restores in the other, bit for bit.

  * **format**: one ``.npy`` file per leaf, keyed by the leaf's path in the
    nested dict (keys sorted at every level, joined by ``/``; the file name
    replaces ``/`` by ``__``), and a ``manifest.json`` of the step and each
    leaf's file, shape and dtype.  bf16 leaves are stored as ``uint16``
    views with ``"dtype": "bfloat16"``, as the reference stores its
    ml_dtypes arrays;
  * **atomic**: a checkpoint is written under ``step_N.tmp`` and renamed to
    ``step_N`` only after every leaf and the manifest are fsynced, so a
    crash mid-write never corrupts the newest complete checkpoint;
  * **restart**: ``restore_checkpoint`` returns the newest complete step,
    and the trainer resumes from it; older checkpoints are pruned to
    ``keep``.

Sharded state (DTensor leaves) is gathered leaf by leaf to the same format
(rank 0 writes, every rank waits for it), and a restore distributes each
leaf to its target leaf's placements: a sharded run's checkpoint restores
into an unsharded run and the other way round.  A plain target leaf goes to
its device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models.bridge import tensor_from_numpy
from repro_torch.training.optimizer import full_value, tree_paths


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array to store, the manifest's dtype name): bf16, which numpy
    lacks, as a uint16 view named ``bfloat16``; any other dtype as numpy
    names it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; prune old ones.
    Every rank of a sharded run calls it (the leaves are gathered)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = sh.is_rank0()
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    manifest = {"step": step, "leaves": {}}
    for key, leaf in tree_paths(tree):
        leaf = full_value(leaf)
        if not writer:
            continue
        store, dtype_name = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, store)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][key] = {"file": fname, "shape": list(store.shape), "dtype": dtype_name}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        for s in all_steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    _barrier()
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any, *, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (a nested dict of tensors):
    each leaf with its stored dtype, on its target leaf's device, and a
    DTensor target's leaf distributed to its placements.  Raises if a leaf's
    shape or dtype differs from the target's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key: str, tgt: torch.Tensor) -> torch.Tensor:
        rec = manifest["leaves"][key]
        t = tensor_from_numpy(np.load(os.path.join(path, rec["file"])), tgt.device, rec["dtype"])
        if tuple(t.shape) != tuple(tgt.shape) or t.dtype != tgt.dtype:
            raise ValueError(f"checkpoint leaf {key}: stored {tuple(t.shape)} {t.dtype}, "
                             f"target {tuple(tgt.shape)} {tgt.dtype}")
        if sh.is_dtensor(tgt):
            return sh.distribute_as(t, tgt.device_mesh, tuple(tgt.placements))
        return t

    def build(t: Any, prefix: str) -> Any:
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in t.items()}
        return load(prefix, t)

    return build(target, ""), step

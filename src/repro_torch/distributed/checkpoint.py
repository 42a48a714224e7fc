"""Checkpoints: atomic, versioned, checksummed.

Port of ``repro.distributed.checkpoint``, in its on-disk format, so a
checkpoint written by either package restores in the other and
``tree_digest`` agrees:

    <root>/step_00001000.tmp/     # written here first
        manifest.json             # paths, shapes, dtypes, crc32s, meta
        arr_00000.npy ...         # one file per leaf, in leaf order
    <root>/step_00001000/         # atomic rename on completion

Leaves are walked in the reference's order with its paths
(``repro_torch.tree``). numpy has no bfloat16, so a bf16 leaf is stored as
its uint16 bits under the dtype name ``"bfloat16"``, as the reference
stores it.

Guarantees:
  * a crash mid-write never corrupts a restorable checkpoint (tmp dirs are
    ignored and removed by the next save);
  * every leaf carries a crc32, so silent corruption is found at load, and
    ``restore_valid`` falls back to the newest step that loads;
  * ``AsyncCheckpointer`` copies to host memory at once and writes on a
    background thread;
  * checkpoints hold whole logical arrays, and ``restore(...,
    shardings=)`` places each leaf by its target's specs
    (``tgn_sharding.NamedSharding``, or ``sharding.NamedSharding`` for the
    language models), so one restores onto any mesh shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.utils import resolve_device

Tree = Any
_MANIFEST = "manifest.json"


def _to_saveable(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor or numpy array) as the numpy array the file holds,
    and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # a reference bf16 array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _from_saveable(arr: np.ndarray, dtype_name: str,
                   device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def tree_digest(tree: Tree) -> str:
    """Order-stable crc32 over a tree's leaf paths and values: two trees
    digest equal iff every leaf path and every byte match (a cheap content
    fingerprint, not a cryptographic one)."""
    crc = 0
    for path, leaf in tree_mod.flatten_with_path(tree):
        arr, _ = _to_saveable(leaf)
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return f"{crc:08x}"


def save(root: str, step: int, tree: Tree, *, meta: dict | None = None,
         keep: int = 3, floor: int | None = None) -> str:
    """Blocking save. Returns the final checkpoint directory. ``floor``
    keeps steps >= it outside the GC keep window."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    entries = []
    for i, (path, leaf) in enumerate(tree_mod.flatten_with_path(tree)):
        arr_s, dtype_name = _to_saveable(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr_s)
        entries.append({
            "path": path, "file": fname, "shape": list(arr_s.shape),
            "dtype": dtype_name,
            "crc32": zlib.crc32(np.ascontiguousarray(arr_s).tobytes()),
        })
    manifest = {"step": step, "leaves": entries, "meta": meta or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _gc(root, keep, protect=os.path.basename(final), floor=floor)
    return final


def _gc(root: str, keep: int, protect: str | None = None,
        floor: int | None = None) -> None:
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        # never the checkpoint this save just committed, nor a step at or
        # above the caller's floor
        if d == protect:
            continue
        if floor is not None and int(d.split("_")[1]) >= floor:
            continue
        shutil.rmtree(os.path.join(root, d))
    for d in os.listdir(root):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d))


def list_steps(root: str) -> list:
    """Every committed step under ``root``, ascending (tmp dirs and
    directories without a manifest are not restorable)."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(root)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and os.path.exists(os.path.join(root, d, _MANIFEST)))


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


#: exceptions that mean "this step is corrupt, an older one may not be":
#: unreadable or truncated files, a crc mismatch (IOError is OSError), a
#: mangled manifest, a missing leaf, a shape that drifted.
CORRUPTION_ERRORS = (OSError, json.JSONDecodeError, KeyError, ValueError)


def restore_valid(root: str, tree_like: Tree, *, device=None,
                  shardings: Tree | None = None) -> tuple:
    """``restore`` of the newest step that loads and verifies, walking the
    committed steps newest to oldest and warning at each corrupt one.
    Returns ``(tree, meta, step)``. Raises ``FileNotFoundError`` when no
    step exists, and the newest step's error when every step is corrupt."""
    steps = list_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {root}")
    first_err = None
    for step in reversed(steps):
        try:
            tree, meta = restore(root, tree_like, step=step, device=device,
                                 shardings=shardings)
            return tree, meta, step
        except CORRUPTION_ERRORS as e:
            if first_err is None:
                first_err = e
            warnings.warn(
                f"checkpoint {root} step {step} is corrupt ({e}); "
                "falling back to the newest prior valid step")
    raise first_err


def restore(root: str, tree_like: Tree, *, step: int | None = None,
            device=None, shardings: Tree | None = None) -> tuple[Tree, dict]:
    """Load a checkpoint into the structure of ``tree_like`` (leaves with a
    ``shape``), as tensors on ``device`` (``cuda`` unless the caller names
    another), or with ``shardings`` (a tree congruent to ``tree_like`` of
    ``NamedSharding``s, ``tgn_sharding``'s or ``sharding``'s) each leaf
    placed by its sharding's ``place``: on its mesh's first device, or as
    the pieces its spec splits it into. Returns ``(tree, meta)``. Raises on a checksum mismatch
    or a structure that drifted."""
    if shardings is None:
        device = resolve_device(device)
        place = [None] * len(tree_mod.leaves(tree_like))
    else:
        device = "cpu"
        place = [s.place for s in tree_mod.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))]
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)

    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for (path, like), put in zip(tree_mod.flatten_with_path(tree_like),
                                 place):
        e = by_path.get(path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(os.path.join(d, e["file"]))
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != e["crc32"]:
            raise IOError(f"checksum mismatch on {path!r}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path!r}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        leaf = _from_saveable(arr, e["dtype"], device)
        out.append(leaf if put is None else put(leaf))
    return tree_mod.unflatten(tree_like, out), manifest["meta"]


class AsyncCheckpointer:
    """Background-thread checkpointing. ``save`` copies the tree to host
    memory before it returns and writes it on a worker thread; ``wait``
    joins the write in flight and raises its error (call it before the
    process exits)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Tree, meta: dict | None = None):
        self.wait()
        host_tree = tree_mod.map(
            lambda x: x.detach().to("cpu", copy=True) if isinstance(
                x, torch.Tensor) else np.array(x), tree)

        def work():
            try:
                save(self.root, step, host_tree, meta=meta, keep=self.keep)
            except Exception as e:  # raised by the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

"""Checkpoint/restart: atomic, checksummed, double-buffered, async.

Ported from ``repro.runtime.checkpoint`` for trees of torch tensors, in
``repro``'s on-disk format, so that a checkpoint written by either package
restores in the other:

* leaves in ``jax.tree.flatten``'s order: dicts by sorted key, lists and
  tuples in order, ``None`` an empty subtree, anything else a leaf;
* dtype names are numpy's (``"float32"``, ``"int32"``, ``"bfloat16"``);
  bfloat16 bytes move through an int16 view, with no ``ml_dtypes``;
* the manifest's ``treedef`` is this package's own description of the
  tree; ``repro`` never reads it back, and neither does this module.

Units and contracts:

* :func:`save_checkpoint` serializes a tree under ``step_<N>`` (steps
  are dimensionless training/solver iterations) and only then atomically
  repoints ``LATEST`` — a crashed writer leaves at most a ``*.tmp-*``
  directory, never a corrupt ``LATEST`` target.
* :func:`restore_checkpoint` restores into the *structure* of a template
  tree: leaf count and per-leaf shape must match, and every leaf's sha256
  is verified (``IOError`` on mismatch) unless ``validate=False``.  The
  restored leaves are tensors on their template leaf's device (the CPU
  for a template leaf that is not a tensor).
* :meth:`CheckpointManager.save` copies the tree to host memory BEFORE
  returning, so with ``async_save=True`` the caller may mutate its
  tensors immediately; a failed background save surfaces as an exception
  on the next :meth:`CheckpointManager.wait` / ``save`` /
  ``restore_latest``.
* :meth:`CheckpointManager.restore_latest` waits for any in-flight save
  first, then restores the newest *complete* checkpoint: partial
  ``*.tmp-*`` directories from an interrupted async save are invisible to
  ``LATEST`` and to garbage collection, so a crash mid-save falls back to
  the previous step.

Layout (one directory per step)::

    <dir>/step_000000042/
        manifest.json      # tree structure, shapes, dtypes, sha256 per leaf
        leaf_00000.bin     # raw bytes per leaf (bfloat16-safe)
        ...
    <dir>/LATEST           # atomic pointer file
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# numpy's name of each torch dtype a leaf may have (bfloat16 by name only:
# numpy has no such dtype without ml_dtypes)
_NP_NAME = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order, ``None`` an empty subtree."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner},)"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def _rebuild(seq, items: List[Any]):
    """A list or tuple of ``seq``'s type holding ``items``; a NamedTuple
    takes them as its fields."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`_flatten`'s order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if isinstance(x, (list, tuple)):
            return _rebuild(x, [build(v) for v in x])
        return next(it)

    return build(template)


def _leaf_bytes(x) -> Tuple[bytes, str, Tuple[int, ...]]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = _NP_NAME[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), name, tuple(x.shape)
    arr = np.asarray(x)
    return arr.tobytes(), str(arr.dtype), tuple(arr.shape)


def _restore_leaf(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic checksummed save; returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6) % 100000}"
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = _flatten(tree)
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        raw, dtype, shape = _leaf_bytes(leaf)
        fn = f"leaf_{i:05d}.bin"
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(raw)
        manifest["leaves"].append({
            "file": fn,
            "dtype": dtype,
            "shape": list(shape),
            "sha256": hashlib.sha256(raw).hexdigest(),
            "bytes": len(raw),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, f".LATEST.tmp-{os.getpid()}")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(
    ckpt_dir: str,
    template: Any,
    step: Optional[int] = None,
    validate: bool = True,
) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (shapes must match),
    each leaf on its template leaf's device.  Integrity: every leaf's
    sha256 is verified unless validate=False."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_t, _ = _flatten(template)
    if manifest["n_leaves"] != len(leaves_t):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template "
            f"{len(leaves_t)} — incompatible structure"
        )
    out: List[torch.Tensor] = []
    for i, (meta, tleaf) in enumerate(zip(manifest["leaves"], leaves_t)):
        with open(os.path.join(path, meta["file"]), "rb") as f:
            raw = f.read()
        if validate:
            digest = hashlib.sha256(raw).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(
                    f"checksum mismatch in {meta['file']} "
                    f"(checkpoint corrupt)"
                )
        t = _restore_leaf(raw, meta["dtype"], meta["shape"])
        tshape = tuple(getattr(tleaf, "shape", ()) or ())
        if tshape != tuple(t.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(t.shape)} != template "
                f"{tshape}"
            )
        if isinstance(tleaf, torch.Tensor):
            t = t.to(tleaf.device)
        out.append(t)
    return step, _unflatten(template, out)


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor leaf (so the caller may mutate its own
    tensors once :meth:`CheckpointManager.save` returns)."""
    leaves, _ = _flatten(tree)
    return _unflatten(tree, [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
        else np.array(x) for x in leaves
    ])


class CheckpointManager:
    """keep-last-k + optional async background writer."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def save(self, step: int, tree: Any):
        self.wait()
        # snapshot to host NOW so the caller can mutate tensors after return
        host_tree = _to_host(tree)

        def work():
            try:
                save_checkpoint(self.dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                e, self._error = self._error, None
                raise e

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.dir)
            if d.startswith("step_") and ".tmp" not in d
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any]]:
        self.wait()
        if latest_step(self.dir) is None:
            return None
        return restore_checkpoint(self.dir, template)

"""Fault-tolerant checkpointing in the reference's on-disk format.

Counterpart of ``repro/train/checkpoint.py``, writing what it writes, so a
checkpoint written by either package restores in the other:
  * one ``shards.npz`` holding each leaf's raw bytes (npz has no bfloat16)
    under a key derived from its name, plus ``manifest.json`` with the step,
    ``extra`` and each leaf's file key, shape, dtype name (``"bfloat16"``,
    ``"float32"``, ``"int32"``) and content hash,
  * writes go to a temp dir, fsync'd, then atomically renamed — a crash
    mid-save never corrupts the latest checkpoint,
  * async save: a background thread serializes host copies snapshotted at
    call time (training continues),
  * ELASTIC restore: the checkpoint stores the GLOBAL logical arrays;
    loading places them onto whatever mesh and placements the new job
    provides (``restore(..., shardings=)``), as DTensors,
  * resume metadata (step) for exact deterministic continuation,
  * retention: keep_last N checkpoints garbage-collected.

A tree is a nested dict whose leaves are tensors (on any device) or numpy
arrays; a leaf's name is its path joined by "/", keys in sorted order as
JAX flattens them.  The port's train state goes through
``models/convert.state_to_jax`` first, so its leaves carry the reference's
names (``params/groups/b0/attn/wq`` stacked over groups, ``opt/mu/...``,
``opt/step``).  A tree of DTensors is saved by gathering it first
(``full_tensor``) and writing it from one process.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import distribute

MANIFEST = "manifest.json"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            flat.update(_flatten(val, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = val
    return flat


def _host(leaf) -> Tuple[bytes, list, str]:
    """(raw bytes, shape, dtype name) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return raw, list(t.shape), str(t.dtype).removeprefix("torch.")
    a = np.ascontiguousarray(leaf)
    if a.dtype.hasobject:
        raise TypeError(f"a checkpoint leaf must be a tensor or a numeric "
                        f"array, not {type(leaf).__name__}")
    return a.tobytes(), list(a.shape), str(a.dtype)


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def save(path: str, tree: Mapping, *, step: int = 0,
         extra: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint dir."""
    flat = _flatten(tree)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    manifest = {"step": int(step), "extra": extra or {}, "leaves": {}}
    try:
        arrays = {}
        for name, leaf in flat.items():
            raw, shape, dtype = _host(leaf)
            key = hashlib.sha1(name.encode()).hexdigest()[:16]
            arrays[key] = np.frombuffer(raw, dtype=np.uint8)
            manifest["leaves"][name] = {
                "file": key,
                "shape": shape,
                "dtype": dtype,
                "hash": hashlib.sha256(raw).hexdigest()[:32],
            }
        shards = os.path.join(tmp, "shards.npz")
        np.savez(shards, **arrays)
        _fsync_file(shards)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc_old(path, keep_last)
    return path


def _gc_old(path: str, keep_last: int):
    """Retention for step-suffixed siblings (ckpt_000010 style)."""
    parent = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    prefix = base.rstrip("0123456789")
    if prefix == base:
        return
    sibs = sorted(d for d in os.listdir(parent)
                  if d.startswith(prefix)
                  and d[len(prefix):].isdigit()
                  and os.path.isdir(os.path.join(parent, d)))
    for d in sibs[:-keep_last]:
        shutil.rmtree(os.path.join(parent, d), ignore_errors=True)


def _snapshot(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Background-thread saver: snapshot on the caller thread (host copies,
    so the caller may go on updating its tensors in place), serialize and
    write off-thread.  wait() joins the in-flight save (call before exit or
    before starting a dependent restore)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree: Mapping, **kw):
        self.wait()
        snapshot = {name: _snapshot(leaf)
                    for name, leaf in _flatten(tree).items()}

        def work():
            try:
                save(path, snapshot, **kw)
            except BaseException as e:   # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_manifest(path: str) -> Dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def restore(path: str, like: Mapping, *, shardings: Optional[Mapping] = None,
            verify: bool = True) -> Tuple[Dict, Dict]:
    """Restore into the structure of ``like`` (a tree whose leaves have
    ``shape`` and ``dtype``: tensors, or numpy arrays of a dtype torch
    has).  Each leaf comes back as a CPU tensor of its ``like`` leaf's
    dtype.  ``shardings``: optional tree of ``distributed.sharding
    .NamedSharding`` matching ``like`` (a leaf may be left out): such a
    leaf comes back as a DTensor placed so on its mesh, ELASTIC: any mesh
    works, whatever mesh wrote the checkpoint (every rank calls restore,
    reads the whole leaf and keeps its block).  Returns (tree,
    manifest)."""
    manifest = load_manifest(path)
    flat_shard = _flatten(shardings) if shardings is not None else {}
    restored = {}
    with np.load(os.path.join(path, "shards.npz")) as data:
        for name, spec in _flatten(like).items():
            meta = manifest["leaves"].get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            raw = data[meta["file"]].tobytes()
            if verify:
                h = hashlib.sha256(raw).hexdigest()[:32]
                if h != meta["hash"]:
                    raise IOError(f"checkpoint corruption in leaf {name!r}")
            stored = getattr(torch, meta["dtype"])
            t = torch.frombuffer(bytearray(raw), dtype=stored) \
                if raw else torch.empty(0, dtype=stored)
            t = t.reshape(meta["shape"])
            if tuple(t.shape) != tuple(spec.shape):
                raise ValueError(
                    f"shape mismatch for {name!r}: ckpt {tuple(t.shape)} vs "
                    f"model {tuple(spec.shape)}")
            want = spec.dtype if isinstance(spec.dtype, torch.dtype) \
                else getattr(torch, str(spec.dtype))
            sharding = flat_shard.get(name)
            restored[name] = t.to(want) if sharding is None \
                else distribute(t.to(want), sharding)
    return _unflatten(restored), manifest


def _unflatten(flat: Mapping[str, Any]) -> Dict:
    tree: Dict = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def latest_step_dir(root: str, prefix: str = "ckpt_") -> Optional[str]:
    """Find the newest complete checkpoint under root (crash recovery:
    incomplete temp dirs are invisible because of the atomic rename)."""
    if not os.path.isdir(root):
        return None
    cands = sorted(d for d in os.listdir(root)
                   if d.startswith(prefix)
                   and os.path.exists(os.path.join(root, d, MANIFEST)))
    return os.path.join(root, cands[-1]) if cands else None

"""Artifact / checkpoint store -- the PVC analog, counterpart of
``repro.checkpoint.store``.

Trees (nested dicts, lists and tuples of tensors, numpy arrays and
scalars) are flattened to path-keyed .npz shards; every artifact gets a
content hash, so pipeline steps can be cached (Kubeflow component caching
analog) and model versions can be diffed for canary rollouts.

Keys are the reference's: dict keys and list/tuple indices joined by
``/``, in its flattening order (dict keys sorted, ``None`` an empty
subtree).  A tensor goes to the host first; numpy has no bf16, so a bf16
tensor is stored as fp32.  ``tree_hash`` of a tree equals the reference's
for the same numpy content.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch


def tree_paths(tree: Any, prefix: tuple = ()):
    """(key path, leaf) pairs in the reference's pytree order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict:
    return {_key(path): _host(leaf) for path, leaf in tree_paths(tree)}


def tree_hash(tree: Any) -> str:
    h = hashlib.sha256()
    for key, arr in sorted(_flatten(tree).items()):
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes()[:65536])  # prefix hash
    return h.hexdigest()[:16]


def _rebuild(like: Any, data, prefix: tuple = ()):
    """``like``'s structure with each leaf read from ``data`` under its key,
    in the leaf's dtype, and for a tensor on the leaf's device."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, data, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, prefix + (i,)) for i, v in enumerate(like))
    arr = data[_key(prefix)]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype, device=like.device)
    return arr.astype(like.dtype) if hasattr(like, "dtype") else arr


class ArtifactStore:
    """Content-addressed artifact store rooted at a directory ("volume")."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def tree_uri(self, name: str) -> str:
        """The URI ``save_tree(name, ...)`` writes to and returns."""
        return f"file://{self._path(f'{name}.npz')}"

    # -- trees (params, optimizer states) ------------------------------------
    def save_tree(self, name: str, tree: Any, meta: Optional[dict] = None) -> str:
        flat = _flatten(tree)
        path = self._path(f"{name}.npz")
        np.savez(path, **flat)
        record = {"name": name, "kind": "tree", "hash": tree_hash(tree),
                  "time": time.time(), "meta": meta or {},
                  "leaves": len(flat)}
        with open(self._path(f"{name}.json"), "w") as f:
            json.dump(record, f)
        return self.tree_uri(name)

    def load_tree(self, name: str, like: Any) -> Any:
        """Restore into the structure of ``like``: each leaf takes the dtype
        of ``like``'s leaf, and a tensor leaf its device."""
        with np.load(self._path(f"{name}.npz")) as data:
            return _rebuild(like, data)

    # -- json blobs (metrics, configs, pipeline specs) -----------------------
    def save_json(self, name: str, obj: Any) -> str:
        path = self._path(f"{name}.json")
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, default=str)
        return f"file://{path}"

    def load_json(self, name: str) -> Any:
        with open(self._path(f"{name}.json")) as f:
            return json.load(f)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(f"{name}.json")) or os.path.exists(
            self._path(f"{name}.npz"))

    def list(self) -> list:
        return sorted(os.listdir(self.root))

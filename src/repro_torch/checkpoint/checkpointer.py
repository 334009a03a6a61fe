"""Asynchronous, atomic, integrity-checked checkpoints (port of
``repro/checkpoint/checkpointer.py``, in its file format).

Layout: <dir>/step_<N>/
  manifest.json   — step, keys, shapes, dtypes, sha256 of each array
                    (first 16 hex digits), ``extra``, time stamp
  arrays_0.npz    — every array, its key's '/' written '__'

The keys are the reference's jax tree paths: a dict's entries by key
(sorted, as jax orders them), a tuple's or list's by ``[i]``, a
dataclass's fields by name. The loop saves ``(params, opt)``: the keys
are ``[0]/blocks/attn/wq``, ``[1]/m/...``, ``[1]/v/...``, ``[1]/count``,
and ``.../[0]``, ``.../[1]`` for an int8 moment's codes and scales, so a
checkpoint written by either package restores in the other. A bf16 array
is stored as the reference stores it, its raw two-byte words (numpy's
``V2``), with ``bfloat16`` in the manifest.

  * the copy to the host is synchronous (the tensors may be replaced
    right after ``save`` returns); hashing and the write run on a
    background thread;
  * atomic: written to step_<N>.tmp, then renamed; a crashed save never
    corrupts the latest checkpoint;
  * ``keep`` bounds the checkpoints kept (the oldest go first);
  * integrity: ``restore`` checks every array's hash.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{jax tree path: leaf} in the reference's flatten order."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], key(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, key(f"[{i}]")))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), key(f.name)))
        return out
    return {prefix: tree}


def _unflatten(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, key(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, values, key(f"[{i}]"))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), values, key(f.name))
            for f in dataclasses.fields(tree)})
    return values[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, manifest dtype)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             block: bool = False):
        """Copy to host memory synchronously, write asynchronously."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Dict):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "keys": sorted(host.keys()),
            "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
            "dtypes": {k: dt for k, (_, dt) in host.items()},
            "hashes": {k: _hash(a) for k, (a, _) in host.items()},
            "extra": extra,
            "ts": time.time(),
        }
        np.savez(os.path.join(tmp, "arrays_0.npz"),
                 **{k.replace("/", "__"): a for k, (a, _) in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, verify: bool = True
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target_tree``: each array
        becomes a tensor on its target leaf's device (the host for a
        target leaf that is not a tensor). Raises ``ValueError`` on a
        hash that does not match the manifest's."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        with np.load(os.path.join(path, "arrays_0.npz")) as z:
            for k, leaf in _flatten(target_tree).items():
                arr = z[k.replace("/", "__")]
                if verify and _hash(arr) != manifest["hashes"][k]:
                    raise ValueError(f"corrupt array {k} in {path}")
                t = _from_host(arr, manifest["dtypes"][k])
                out[k] = t.to(leaf.device) if torch.is_tensor(leaf) else t
        return _unflatten(target_tree, out), manifest["extra"]

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

Port decision (speed): an array is hashed over its own bytes (no copy),
and the arrays are hashed on a pool of threads (``hashlib`` releases the
GIL), beside the write on save and beside the reads and the copies to
the device on restore; the digests are the reference's. ``restore``
reads each array with one ``readinto`` at its offset in the file
(``np.savez`` stores members uncompressed), where ``np.load`` reads a
member in 256 KiB pieces through ``zipfile``'s CRC; the hashes check the
bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
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
    """A tensor over ``arr``, which it may share: an array read from a
    checkpoint is the read's own (a copy only where it is not writable
    or not C-ordered)."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_HASH_THREADS = min(8, os.cpu_count() or 1)


def _hash(arr: np.ndarray) -> str:
    """The first 16 hex digits of the sha256 of the array's C-order bytes
    (``arr.tobytes()``), read in place."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(memoryview(flat)).hexdigest()[:16]


def _read_member(f, zf: zipfile.ZipFile, name: str) -> np.ndarray:
    """The array stored as ``name`` in the npz open as ``zf`` over the
    file ``f``: a stored (uncompressed) member with a version 1 or 2
    ``.npy`` header is read with one ``readinto`` at its offset; any
    other through ``zipfile``."""
    info = zf.getinfo(name)
    if info.compress_type == zipfile.ZIP_STORED:
        f.seek(info.header_offset)
        head = f.read(30)
        if head[:4] == b"PK\x03\x04":
            n, m = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + n + m)
            version = np.lib.format.read_magic(f)
            read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                           (2, 0): np.lib.format.read_array_header_2_0}
            if version in read_header:
                shape, fortran, dtype = read_header[version](f)
                if not dtype.hasobject:
                    arr = np.empty(shape[::-1] if fortran else shape, dtype)
                    if arr.nbytes and f.readinto(memoryview(arr).cast(
                            "B")) != arr.nbytes:
                        raise ValueError(f"short read of {name}")
                    return arr.T if fortran else arr
    with zf.open(name) as member:
        return np.lib.format.read_array(member)


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
        with ThreadPoolExecutor(_HASH_THREADS) as pool:
            hashes = {k: pool.submit(_hash, a) for k, (a, _) in host.items()}
            np.savez(os.path.join(tmp, "arrays_0.npz"),
                     **{k.replace("/", "__"): a
                        for k, (a, _) in host.items()})
            hashes = {k: f.result() for k, f in hashes.items()}
        manifest = {
            "step": step,
            "keys": sorted(host.keys()),
            "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
            "dtypes": {k: dt for k, (_, dt) in host.items()},
            "hashes": hashes,
            "extra": extra,
            "ts": time.time(),
        }
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
        out, hashes = {}, {}
        with open(os.path.join(path, "arrays_0.npz"), "rb") as f, \
                zipfile.ZipFile(f) as zf, \
                ThreadPoolExecutor(_HASH_THREADS) as pool:
            for k, leaf in _flatten(target_tree).items():
                arr = _read_member(f, zf, k.replace("/", "__") + ".npy")
                if verify:
                    hashes[k] = pool.submit(_hash, arr)
                t = _from_host(arr, manifest["dtypes"][k])
                out[k] = t.to(leaf.device) if torch.is_tensor(leaf) else t
            for k, f in hashes.items():
                if f.result() != manifest["hashes"][k]:
                    raise ValueError(f"corrupt array {k} in {path}")
        return _unflatten(target_tree, out), manifest["extra"]

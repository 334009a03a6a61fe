"""Transparent multimodal storage — the platform's "data lake" layer.
(Port copy of ``repro/core/lake.py``: numpy only, host-resident.)

An ``MMOTable`` is the TPU-native analogue of the paper's Hudi DataFrame:
one row per multimodal object (MMO), columns are either numeric attributes
(scalars) or vector attributes (embeddings), plus bookkeeping that keeps the
storage *transparent*: every row records the raw-data URI and the embedding
model that produced each vector column, so query results trace back to the
original multimodal payload (paper §4.1).

Physical layout adaptation (Spark/Hudi -> TPU):
  * columnar SoA numpy arrays (host) mirrored to jnp for compute
  * rows are re-orderable: the learned index assigns each row to a leaf
    "bucket"; ``apply_permutation`` physically clusters bucket members so a
    bucket is a contiguous, padded slab (static shapes for TPU scans)
  * persistence = npz shards + a JSON manifest (the lake directory)

Write path (async ingest): a prepared table absorbs new rows without a
rebuild through a ``DeltaRegion`` — a pow2-capacity append buffer that
mirrors the table's schema. The delta lifecycle is append -> union ->
fold: ``MQRLD.append`` lands rows here (queries union them in from the
next execute on, exactly), and ``MQRLD.fold`` / the next ``prepare()``
merges them into the learned index. Pad rows are NaN-filled so every
predicate evaluates False on them without extra masking; capacities grow
in powers of two so the compiled-shape universe of the batched engine
stays logarithmic in the number of appends.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class MMOTable:
    name: str
    numeric: Dict[str, np.ndarray] = field(default_factory=dict)   # (N,)
    vector: Dict[str, np.ndarray] = field(default_factory=dict)    # (N, d)
    raw_uri: Optional[np.ndarray] = None                            # (N,) str
    embed_model: Dict[str, str] = field(default_factory=dict)      # col->model
    # physical bucket layout (filled by the learned index build)
    bucket_id: Optional[np.ndarray] = None       # (N,) int32, physical order
    bucket_starts: Optional[np.ndarray] = None   # (B+1,) int32 prefix offsets
    row_ids: Optional[np.ndarray] = None         # (N,) original row id

    # ------------------------------------------------------------------ build
    @property
    def n_rows(self) -> int:
        for a in self.numeric.values():
            return len(a)
        for a in self.vector.values():
            return len(a)
        return 0

    @property
    def n_buckets(self) -> int:
        return 0 if self.bucket_starts is None else len(self.bucket_starts) - 1

    def add_numeric(self, name: str, values) -> "MMOTable":
        self.numeric[name] = np.asarray(values, np.float32)
        return self

    def add_vector(self, name: str, values, model: str = "") -> "MMOTable":
        self.vector[name] = np.asarray(values, np.float32)
        if model:
            self.embed_model[name] = model
        return self

    def with_raw(self, uris: Sequence[str]) -> "MMOTable":
        self.raw_uri = np.asarray(list(uris), dtype=object)
        return self

    def validate(self):
        n = self.n_rows
        for k, a in self.numeric.items():
            assert a.shape == (n,), (k, a.shape)
        for k, a in self.vector.items():
            assert a.ndim == 2 and a.shape[0] == n, (k, a.shape)
        if self.raw_uri is not None:
            assert len(self.raw_uri) == n
        return self

    # --------------------------------------------------------- concatenation
    def concat_features(self, columns: Optional[List[str]] = None):
        """Matrix D (paper §5.2.2 Step 1): selected columns, vectors first.

        Returns (D, layout) where layout maps column -> (start, end) slice.
        """
        cols = columns or (list(self.vector) + list(self.numeric))
        parts, layout, off = [], {}, 0
        for c in cols:
            if c in self.vector:
                a = self.vector[c]
            else:
                a = self.numeric[c][:, None]
            parts.append(a.astype(np.float32))
            layout[c] = (off, off + a.shape[1] if a.ndim == 2 else off + 1)
            off += a.shape[1]
        return np.concatenate(parts, axis=1), layout

    # ----------------------------------------------------------- permutation
    def apply_permutation(self, perm: np.ndarray, bucket_id: np.ndarray,
                          bucket_starts: np.ndarray) -> "MMOTable":
        """Physically reorder rows into bucket-contiguous layout."""
        out = MMOTable(
            name=self.name,
            numeric={k: v[perm] for k, v in self.numeric.items()},
            vector={k: v[perm] for k, v in self.vector.items()},
            raw_uri=None if self.raw_uri is None else self.raw_uri[perm],
            embed_model=dict(self.embed_model),
            bucket_id=np.asarray(bucket_id, np.int32),
            bucket_starts=np.asarray(bucket_starts, np.int32),
            row_ids=(self.row_ids[perm] if self.row_ids is not None
                     else np.asarray(perm, np.int32)),
        )
        return out

    # -------------------------------------------------------------- tracing
    def get_mmos(self, rows: Sequence[int]) -> List[Dict]:
        """Transparent retrieval: full MMO records incl. raw pointers."""
        out = []
        for r in rows:
            r = int(r)
            rec = {"row": r,
                   "id": int(self.row_ids[r]) if self.row_ids is not None
                   else r}
            rec.update({k: float(v[r]) for k, v in self.numeric.items()})
            rec.update({k: v[r] for k, v in self.vector.items()})
            if self.raw_uri is not None:
                rec["raw_uri"] = str(self.raw_uri[r])
            rec["embed_model"] = dict(self.embed_model)
            out.append(rec)
        return out

    # ---------------------------------------------------------- persistence
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        manifest = {
            "name": self.name,
            "numeric": list(self.numeric),
            "vector": list(self.vector),
            "embed_model": self.embed_model,
            "has_raw": self.raw_uri is not None,
            "has_buckets": self.bucket_starts is not None,
            "n_rows": self.n_rows,
        }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        arrays = {}
        for k, v in self.numeric.items():
            arrays[f"num__{k}"] = v
        for k, v in self.vector.items():
            arrays[f"vec__{k}"] = v
        if self.raw_uri is not None:
            arrays["raw_uri"] = np.asarray(self.raw_uri, dtype=np.str_)
        if self.bucket_starts is not None:
            arrays["bucket_id"] = self.bucket_id
            arrays["bucket_starts"] = self.bucket_starts
            arrays["row_ids"] = self.row_ids
        np.savez_compressed(os.path.join(directory, "columns.npz"), **arrays)

    @classmethod
    def load(cls, directory: str) -> "MMOTable":
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        z = np.load(os.path.join(directory, "columns.npz"), allow_pickle=False)
        t = cls(name=manifest["name"],
                embed_model=manifest.get("embed_model", {}))
        for k in manifest["numeric"]:
            t.numeric[k] = z[f"num__{k}"]
        for k in manifest["vector"]:
            t.vector[k] = z[f"vec__{k}"]
        if manifest.get("has_raw"):
            t.raw_uri = z["raw_uri"].astype(object)
        if manifest.get("has_buckets"):
            t.bucket_id = z["bucket_id"]
            t.bucket_starts = z["bucket_starts"]
            t.row_ids = z["row_ids"]
        return t


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): pads variable-size subsets —
    delta capacities here, compiled batch/union shapes in the engine —
    so the compiled-shape universe stays logarithmic."""
    return 1 << max(0, int(n) - 1).bit_length()


class DeltaRegion:
    """Pow2-capacity append buffer over one MMOTable's schema.

    Freshly ingested rows live here — padded columnar buffers sized to a
    power-of-two capacity — until ``fold()``/``prepare()`` merges them
    into the learned index. Row ``j`` of the region is addressed globally
    as ``n_base + j`` by every query path. Slots past ``m`` (the live
    count) are NaN so predicates evaluate False on them; the engine
    additionally masks them out of KNN tiles via ``-1`` row ids.

    ``epoch`` increments on every mutation (append/clear): device-state
    and view caches key on it. ``append`` validates the batch completely
    before touching any buffer, so a failed append leaves the region —
    and everything unioned over it — unchanged.
    """

    def __init__(self, numeric_dims: Dict[str, int],
                 vector_dims: Dict[str, int], has_raw: bool):
        self.vector_dims = dict(vector_dims)
        self.numeric_keys = list(numeric_dims)
        self.numeric: Dict[str, np.ndarray] = {}
        self.vector: Dict[str, np.ndarray] = {}
        self.raw_uri: Optional[List[str]] = [] if has_raw else None
        self.m = 0
        self.capacity = 0
        self.epoch = 0

    @classmethod
    def for_table(cls, table: "MMOTable") -> "DeltaRegion":
        return cls({k: 1 for k in table.numeric},
                   {k: int(v.shape[1]) for k, v in table.vector.items()},
                   table.raw_uri is not None)

    # ------------------------------------------------------------- append
    def _validate(self, numeric, vector, n_new: int):
        if n_new <= 0:
            raise ValueError("append needs at least one row")
        if set(numeric) != set(self.numeric_keys):
            raise ValueError(
                f"append must supply every numeric column: got "
                f"{sorted(numeric)}, schema {sorted(self.numeric_keys)}")
        if set(vector) != set(self.vector_dims):
            raise ValueError(
                f"append must supply every vector column: got "
                f"{sorted(vector)}, schema {sorted(self.vector_dims)}")
        for k, v in numeric.items():
            if v.shape != (n_new,):
                raise ValueError(f"numeric {k!r}: shape {v.shape} != "
                                 f"({n_new},)")
        for k, v in vector.items():
            if v.ndim != 2 or v.shape != (n_new, self.vector_dims[k]):
                raise ValueError(
                    f"vector {k!r}: shape {v.shape} != "
                    f"({n_new}, {self.vector_dims[k]})")

    def _grow(self, cap: int):
        for k in self.numeric_keys:
            col = np.full(cap, np.nan, np.float32)
            if k in self.numeric:
                col[:self.m] = self.numeric[k][:self.m]
            self.numeric[k] = col
        for k, d in self.vector_dims.items():
            col = np.full((cap, d), np.nan, np.float32)
            if k in self.vector:
                col[:self.m] = self.vector[k][:self.m]
            self.vector[k] = col
        self.capacity = cap

    def append(self, numeric: Dict[str, np.ndarray],
               vector: Dict[str, np.ndarray],
               raw_uri: Optional[Sequence[str]] = None) -> int:
        """Validate-then-write: returns the new live row count."""
        numeric = {k: np.asarray(v, np.float32) for k, v in numeric.items()}
        vector = {k: np.asarray(v, np.float32) for k, v in vector.items()}
        n_new = 0
        for v in list(numeric.values()) + list(vector.values()):
            n_new = max(n_new, len(v))
        self._validate(numeric, vector, n_new)
        if raw_uri is not None and len(raw_uri) != n_new:
            raise ValueError("raw_uri length != appended row count")
        if self.m + n_new > self.capacity:
            self._grow(_next_pow2(self.m + n_new))
        s = self.m
        for k, v in numeric.items():
            self.numeric[k][s:s + n_new] = v
        for k, v in vector.items():
            self.vector[k][s:s + n_new] = v
        if self.raw_uri is not None:
            uris = list(raw_uri) if raw_uri is not None else [""] * n_new
            self.raw_uri.extend(str(u) for u in uris)
        self.m += n_new
        self.epoch += 1
        return self.m

    # -------------------------------------------------------------- reads
    def live_numeric(self, attr: str) -> np.ndarray:
        return self.numeric[attr][:self.m]

    def live_vector(self, attr: str) -> np.ndarray:
        return self.vector[attr][:self.m]

    def n_tiles(self, cap: int) -> int:
        """Tile count of the delta at ``cap`` rows per tile (fixed by the
        capacity, not the live count, so tile shapes survive appends)."""
        return 0 if self.capacity == 0 else -(-self.capacity // cap)

    def clear(self):
        self.numeric = {}
        self.vector = {}
        if self.raw_uri is not None:
            self.raw_uri = []
        self.m = 0
        self.capacity = 0
        self.epoch += 1


class DataLake:
    """Directory of MMO tables (the lake root), one ``MMOTable.save``
    directory per table name."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_tables(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def write(self, table: MMOTable):
        table.save(os.path.join(self.root, table.name))

    def read(self, name: str) -> MMOTable:
        return MMOTable.load(os.path.join(self.root, name))

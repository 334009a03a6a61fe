"""Index persistence — port of ``repro/core/persist.py``: the cluster
tree, enhanced features and transform live next to the MMO table in the
lake, so a platform restarts without a rebuild (the paper's
offline-build / online-serve split). The files are the reference's, name
for name and key for key, so a snapshot saved by either package loads in
the other.

Versioned snapshot layout (crash-atomic, rollback-capable):

    <directory>/
      CURRENT            -> "gen-0003"   (the serving snapshot)
      gen-0002/          table/ index/ qbs.json platform.json
      gen-0003/          [cost_model.json quant.npz delta.npz]

``save_platform`` writes the whole snapshot into a hidden temp dir and
``os.replace``s it to its ``gen-XXXX`` name, then flips ``CURRENT``
through the same write-temp + rename step: a crash at any point leaves
either the old serving snapshot intact or the new one installed, never a
mixed directory. ``load_platform`` resolves ``CURRENT`` (a flat legacy
directory still loads); ``rollback_platform`` flips ``CURRENT`` back to
the previous retained generation, the durable end of
``MQRLD.rollback()``. Retention is bounded (``_KEEP_GENERATIONS``): the
serving snapshot and its rollback target survive, older ones are pruned
after the flip.

``load_platform`` follows the port's device rule: the CUDA card by
default, ``device="cpu"`` for the plain versions.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.index import ClusterTree
from repro_torch.core.lake import MMOTable
from repro_torch.core.transform import HyperspaceTransform

_KEEP_GENERATIONS = 2   # serving + rollback target


def save_index(directory: str, tree: ClusterTree,
               enhanced: np.ndarray,
               transform: Optional[HyperspaceTransform] = None,
               columns: Optional[list] = None):
    """``index.npz`` (the tree's arrays, its sibling lists as CSR, the
    enhanced features and the transform) and ``index.json``."""
    os.makedirs(directory, exist_ok=True)
    flat_children = []
    child_offsets = [0]
    for c in tree.children:
        flat_children.extend(c)
        child_offsets.append(len(flat_children))
    arrays = dict(
        centroid=tree.centroid, radius=tree.radius, parent=tree.parent,
        is_leaf=tree.is_leaf, bucket_start=tree.bucket_start,
        bucket_end=tree.bucket_end, lm_a=tree.lm_a, lm_b=tree.lm_b,
        depth=tree.depth, access_count=tree.access_count,
        children_flat=np.asarray(flat_children, np.int32),
        children_off=np.asarray(child_offsets, np.int64),
        enhanced=np.asarray(enhanced, np.float32),
    )
    if transform is not None:
        arrays.update(t_r=transform.r, t_s=transform.s, t_mean=transform.mean)
    np.savez_compressed(os.path.join(directory, "index.npz"), **arrays)
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump({"n_nodes": tree.n_nodes,
                   "has_transform": transform is not None,
                   # the build's feature-column order: fold() after a
                   # reload assembles delta features in exactly it
                   "columns": columns}, f)


def load_index(directory: str):
    """Returns (tree, enhanced, transform-or-None)."""
    with open(os.path.join(directory, "index.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(directory, "index.npz"))
    off = z["children_off"]
    flat = z["children_flat"]
    children = [flat[off[i]:off[i + 1]].tolist()
                for i in range(len(off) - 1)]
    tree = ClusterTree(
        centroid=z["centroid"], radius=z["radius"], parent=z["parent"],
        children=children, is_leaf=z["is_leaf"],
        bucket_start=z["bucket_start"], bucket_end=z["bucket_end"],
        lm_a=z["lm_a"], lm_b=z["lm_b"], depth=z["depth"],
        access_count=z["access_count"])
    transform = None
    if meta.get("has_transform"):
        transform = HyperspaceTransform(r=z["t_r"], s=z["t_s"],
                                        mean=z["t_mean"])
    return tree, z["enhanced"], transform


# ---------------------------------------------------------------- layout
def _gen_name(g: int) -> str:
    return f"gen-{g:04d}"


def list_generations(directory: str) -> List[int]:
    """Generation numbers retained under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("gen-") and os.path.isdir(
                os.path.join(directory, d)):
            try:
                out.append(int(d[4:]))
            except ValueError:
                continue
    return sorted(out)


def current_generation(directory: str) -> Optional[int]:
    """The generation ``CURRENT`` points at, or None (legacy layout or an
    empty directory)."""
    cur = os.path.join(directory, "CURRENT")
    if not os.path.exists(cur):
        return None
    with open(cur) as f:
        name = f.read().strip()
    try:
        return int(name[4:]) if name.startswith("gen-") else None
    except ValueError:
        return None


def _set_current(directory: str, g: int):
    """Flip the ``CURRENT`` pointer atomically (write-temp + rename: the
    commit point of every save and rollback)."""
    tmp = os.path.join(directory, f".CURRENT.tmp-{uuid.uuid4().hex[:8]}")
    with open(tmp, "w") as f:
        f.write(_gen_name(g))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, "CURRENT"))


def _write_snapshot(platform, directory: str):
    """One complete platform state into ``directory`` (assumed fresh)."""
    platform.table.save(os.path.join(directory, "table"))
    save_index(os.path.join(directory, "index"), platform.tree,
               platform.enhanced, platform.transform,
               columns=list(platform.layout))
    platform.qbs.save(os.path.join(directory, "qbs.json"))
    with open(os.path.join(directory, "platform.json"), "w") as f:
        json.dump({"default_shards": platform.default_shards,
                   "default_precision": platform.default_precision,
                   "generation": platform.generation}, f)
    # the calibrated cost model rides along (with its host fingerprint:
    # a snapshot moved to another host should recalibrate)
    if platform.cost_model is not None:
        with open(os.path.join(directory, "cost_model.json"), "w") as f:
            json.dump(platform.cost_model.to_dict(), f, indent=1)
    # an int8 default's base-layout planes, when an engine of that
    # precision has quantized them: a reloaded platform serves without
    # re-quantizing (the engine re-checks their shape, so a stale file
    # only costs a re-quantization). bf16 planes are a cast, cheaper to
    # rebuild than to store
    planes = None
    if platform.default_precision == "int8":
        for eng in platform._engines.values():
            if eng.precision == platform.default_precision \
                    and eng._planes_np:
                planes = eng.snapshot_planes()
                break
    if planes:
        np.savez_compressed(os.path.join(directory, "quant.npz"), **planes)
    d = platform.delta
    if d is not None and d.m:
        arrays = {f"num__{k}": d.live_numeric(k) for k in d.numeric_keys}
        arrays.update({f"vec__{k}": d.live_vector(k)
                       for k in d.vector_dims})
        if d.raw_uri is not None:
            arrays["raw_uri"] = np.asarray(d.raw_uri, dtype=np.str_)
        np.savez_compressed(os.path.join(directory, "delta.npz"), **arrays)


def save_platform(platform, directory: str):
    """Lake table + index + transform in one crash-atomic generation
    snapshot, with the live (un-folded) delta rows beside it, so a
    restart serves the freshest data without a fold. ``default_shards``
    rides in platform.json; the sharded layout itself is derived state
    (permuted from the tiles by the first sharded engine), never
    stored.

    The snapshot lands as ``<directory>/gen-XXXX`` (XXXX =
    ``platform.generation``, or the next free number when that one is
    retained already) through a temp dir and ``os.replace``; ``CURRENT``
    flips to it as the one commit point, so a crash mid-save leaves the
    previous snapshot serving. The previous generation is kept for
    ``rollback_platform``, older ones are pruned. Sets
    ``platform.snapshot_dir``."""
    os.makedirs(directory, exist_ok=True)
    g = platform.generation
    while os.path.isdir(os.path.join(directory, _gen_name(g))):
        g += 1
    target = os.path.join(directory, _gen_name(g))
    tmp = os.path.join(directory, f".tmp-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        _write_snapshot(platform, tmp)
        os.replace(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _set_current(directory, g)         # commit point
    # bounded retention: serving + rollback target (the serving
    # generation is never pruned, whatever its number)
    gens = list_generations(directory)
    keep = set(gens[-_KEEP_GENERATIONS:]) | {g}
    for old in gens:
        if old not in keep:
            shutil.rmtree(os.path.join(directory, _gen_name(old)),
                          ignore_errors=True)
    platform.snapshot_dir = directory


def _resolve_snapshot(directory: str,
                      generation: Optional[int] = None) -> str:
    """The directory holding the flat snapshot files: a ``gen-XXXX``
    subdir in the versioned layout, ``directory`` itself for a legacy
    flat snapshot."""
    if generation is not None:
        return os.path.join(directory, _gen_name(generation))
    g = current_generation(directory)
    return directory if g is None else os.path.join(directory,
                                                    _gen_name(g))


def _device_count(device: torch.device) -> int:
    """The device count a restored shard count is clamped to, as the
    reference clamps it to ``jax.device_count()``: the CUDA devices on a
    CUDA device, one on the CPU. (A mesh of any S runs on one device, but
    the clamp keeps the reference's loaded topology; ``shards`` at
    ``load_platform`` or ``engine(shards=...)`` asks for another.)"""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def load_platform(directory: str, shards: Optional[int] = None,
                  generation: Optional[int] = None, *, device=None):
    """A ready-to-query ``MQRLD`` on ``device`` (None: the CUDA card)
    without rebuilding the index; un-folded delta rows are re-appended
    (folding is left to the caller or the auto-fold policy).

    Resolves the versioned layout through ``CURRENT`` (``generation``
    pins a retained snapshot instead: the durable rollback's read path);
    a directory without ``CURRENT`` loads as a legacy flat snapshot. The
    saved ``default_shards`` is restored (``shards`` overrides it, None
    keeps the saved one) and clamped to the devices this host has, as
    the reference does; the first sharded engine permutes its layout from
    the loaded tiles. A ``quant.npz`` becomes the
    platform's ``_quant_cache``, which its engines take in place of
    quantizing."""
    from repro_torch.core.platform import MQRLD
    from repro_torch.core.qbs import QBSTable
    root = directory
    directory = _resolve_snapshot(directory, generation)
    table = MMOTable.load(os.path.join(directory, "table"))
    tree, enhanced, transform = load_index(os.path.join(directory, "index"))
    p = MQRLD(table, device=device)
    p.table = table
    p.tree = tree
    p.enhanced = enhanced
    p.transform = transform
    pj = os.path.join(directory, "platform.json")
    if os.path.exists(pj):
        with open(pj) as f:
            pconf = json.load(f)
        p.default_shards = pconf.get("default_shards")
        p.default_precision = pconf.get("default_precision", "fp32")
        p.generation = int(pconf.get("generation", 0))
    if directory != root:
        p.snapshot_dir = root     # versioned layout: disk rollback works
    quant_path = os.path.join(directory, "quant.npz")
    if os.path.exists(quant_path):
        z = np.load(quant_path, allow_pickle=False)
        cache = {k: z[k] for k in z.files}
        cache["precision"] = p.default_precision
        p._quant_cache = cache
    if shards is not None:
        p.default_shards = shards
    if p.default_shards:
        p.default_shards = min(p.default_shards, _device_count(p.device))
    # fold() assembles delta features in the build's column order
    # (snapshots without the field fall back to the default order)
    with open(os.path.join(directory, "index", "index.json")) as f:
        cols = json.load(f).get("columns")
    _, p.layout = table.concat_features(cols)
    qbs_path = os.path.join(directory, "qbs.json")
    if os.path.exists(qbs_path):
        p.qbs = QBSTable.load(qbs_path)
    cm_path = os.path.join(directory, "cost_model.json")
    if os.path.exists(cm_path):
        from repro_torch.core.cost import CostModel
        with open(cm_path) as f:
            p.cost_model = CostModel.from_dict(json.load(f))
    p._build_meta()
    delta_path = os.path.join(directory, "delta.npz")
    if os.path.exists(delta_path):
        z = np.load(delta_path, allow_pickle=False)
        numeric = {k: z[f"num__{k}"] for k in table.numeric}
        vector = {k: z[f"vec__{k}"] for k in table.vector}
        uri = (z["raw_uri"].astype(object).tolist()
               if "raw_uri" in z.files else None)
        p.append(numeric=numeric, vector=vector, raw_uri=uri, fold=False)
    return p


def rollback_platform(directory: str, into=None,
                      shards: Optional[int] = None, *, device=None):
    """Restore the previous retained generation from disk — the durable
    end of ``MQRLD.rollback()``.

    Loads the newest generation below the one ``CURRENT`` names and flips
    ``CURRENT`` back to it (atomic, the same rename step as a save). With
    ``into`` set, the loaded state is grafted onto that live platform in
    place (on its device) and its ``build_id`` bumps, so cached plans,
    engines and device state invalidate as at any index change; the same
    object is returned. Otherwise a fresh platform on ``device`` is
    returned."""
    cur = current_generation(directory)
    if cur is None:
        raise RuntimeError(f"{directory!r} has no versioned snapshots "
                           "(no CURRENT pointer) — nothing to roll back")
    prior = [g for g in list_generations(directory) if g < cur]
    if not prior:
        raise RuntimeError(f"no generation older than {_gen_name(cur)} "
                           "retained on disk")
    target = max(prior)
    p = load_platform(directory, shards=shards, generation=target,
                      device=into.device if into is not None else device)
    _set_current(directory, target)    # commit point
    if into is None:
        return p
    into._invalidate()                 # build_id stays monotone
    for attr in ("raw_table", "table", "tree", "meta", "enhanced",
                 "transform", "layout", "report", "qbs", "delta",
                 "default_shards", "default_precision", "_quant_cache"):
        setattr(into, attr, getattr(p, attr))
    # adopt the snapshot's calibration when it has one, but never wipe a
    # live one: the cost model is a property of the host, not the index
    if p.cost_model is not None:
        into.cost_model = p.cost_model
    into.delta_epoch += 1
    into.snapshot_dir = directory
    return into

"""Logical-axis -> mesh-axis translation for the models' partition specs
(``P``, ``MeshRules``, ``rules_for_mesh``, ``shard``), tile placement for
the hybrid-query engine's sharded execution path and the pod axis of the
compressed train step (``pod_mesh``): port of
``repro/sharding/partitioning.py``.

Parameters, caches and inputs carry *logical* axis names (``batch``,
``heads``, ``embed``, ...); a ``MeshRules`` maps them onto the axes of a
logical mesh (``launch/mesh.py``: ``(data, model)`` or ``(pod, data,
model)``, names and sizes, no devices). The specs it builds are the
reference's, entry for entry; the dry run (``launch/dryrun.py``) divides
each leaf's shape by them to get its bytes on one device. On one card no
tensor is split, so ``shard`` (the reference's sharding constraint)
returns its input.

``tile_mesh`` describes S shards in this process, all placed on one
device. The reference builds a one-axis ``("shards",)`` JAX mesh over S
devices and raises above the device count; here a mesh of any S runs,
since on one card every shard shares it (a mesh over several cards comes
with collectives over ``torch.distributed``).

``strided_tile_layout`` assigns the tile-major ``(T, cap, d)`` bucket
layout to shards STRIDED (tile t -> shard t mod S) rather than in
contiguous blocks: leaves are emitted in tree order, so contiguous blocks
would put whole spatial regions on one shard and every query's best tiles
on a single shard, while the strided assignment gives each shard an even
1/S sample of every region, which is what makes per-shard beam rounds
cover the global best-bound frontier at ~1/S the per-shard width. The
layout contract: the padded tile axis is permuted so shard s owns
positions [s*t_local, (s+1)*t_local); the engine bounds pad positions
+inf (never scanned by a beam, never surviving the V.R triangle bound),
so padding is invisible to every pruning rule.

Collectives: the engine's cross-shard steps go through a
``Collectives`` object over a *shard-stacked* tensor, whose leading axis
holds the shards this process owns in shard order. ``LocalCollectives``
is the in-process implementation, for a mesh whose shards all live in one
process on one device: every shard is local, so ``all_gather`` returns
the stack as it is (concatenation in shard order), ``pmin`` is an
``amin`` over the shard axis and ``psum`` a ``sum``. An implementation
over ``torch.distributed`` (one shard per rank, a leading axis of one)
fits the same three calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.quant import div

MeshAxes = Union[None, str, Tuple[str, ...]]


def _entry(e) -> MeshAxes:
    """A spec entry in ``PartitionSpec``'s canonical form: a sequence of
    one name is that name, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: one entry per dimension, each None (replicated),
    a mesh axis name, or a tuple of names (split over their product).
    A plain tuple, so it equals the reference's ``PartitionSpec`` taken
    as a tuple; entries are canonical as there (a one-name tuple is the
    name)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, map(_entry, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to mesh axes (the reference's, field for
    field)."""

    # data-parallel axes (batch). ("pod", "data") on a multi-pod mesh.
    dp: Tuple[str, ...] = ("data",)
    # tensor-parallel axis; None = TP disabled (the "model" axis is then
    # extra data/FSDP parallelism)
    tp: Optional[str] = "model"
    # FSDP axes for parameter sharding; () disables FSDP
    fsdp: Tuple[str, ...] = ("data",)
    # sequence-parallel axes for long context; shares the data axis
    sp: Tuple[str, ...] = ("data",)
    # mesh axis sizes, for divisibility-aware specs
    sizes: Tuple[Tuple[str, int], ...] = ()

    def axis_size(self, axes: MeshAxes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        table = dict(self.sizes)
        n = 1
        for a in axes:
            n *= table.get(a, 1)
        return n

    def spec(self, *logical: Optional[str]) -> P:
        return P(*[self._resolve(ax) for ax in logical])

    def spec_for(self, shape: Tuple[int, ...],
                 logical: Tuple[Optional[str], ...]) -> P:
        """Shape-aware spec: a mesh axis that does not divide its
        dimension is dropped (the dimension is replicated)."""
        out = []
        for dim, ax in zip(shape, logical):
            resolved = self._resolve(ax)
            n = self.axis_size(resolved)
            out.append(resolved if (n > 1 and dim % n == 0) or n == 1
                       else None)
        return P(*out)

    def kv_spec(self, shape: Tuple[int, ...],
                logical: Tuple[Optional[str], ...],
                batch_dim: int, seq_dim: int) -> P:
        """KV-cache spec: where the sequence dimension is unsplit, the mesh
        axes no other dimension uses (never "pod") split it, all of them
        if they divide it, else the first."""
        sp = list(self.spec_for(shape, logical))
        used = set()
        for entry in sp:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                used.add(a)
        free = [a for a, _ in self.sizes if a not in used and a != "pod"]
        if sp[seq_dim] is None and free:
            for cand in (tuple(free), (free[0],)):
                n = self.axis_size(cand)
                if n > 1 and shape[seq_dim] % n == 0:
                    sp[seq_dim] = cand if len(cand) > 1 else cand[0]
                    break
        return P(*sp)

    def flat_spec(self, n_rows: int) -> P:
        """The widest split of a flat (rows, block) tensor: over fsdp x tp
        when it divides the rows, else over fsdp, else replicated."""
        full = tuple(self.fsdp) + (self.tp,)
        if self.axis_size(full) > 1 and n_rows % self.axis_size(full) == 0:
            return P(full, None)
        f = self.fsdp if len(self.fsdp) > 1 else \
            (self.fsdp[0] if self.fsdp else None)
        if f is not None and n_rows % self.axis_size(f) == 0:
            return P(f, None)
        return P(None, None)

    def _resolve(self, ax: Optional[str]) -> MeshAxes:
        if ax is None:
            return None

        def one(axes: Tuple[str, ...]) -> MeshAxes:
            return axes if len(axes) > 1 else (axes[0] if axes else None)
        table = {
            "batch": one(self.dp), "fsdp": one(self.fsdp),
            "seq_sp": one(self.sp), "vocab": self.tp, "heads": self.tp,
            "kv_heads": self.tp, "ff": self.tp, "experts": self.tp,
            "model": self.tp, "layers": None,
            # parameters' d_model axes; activations never name "embed"
            "embed": one(self.fsdp), "seq": None, "state": None,
        }
        if ax not in table:
            raise KeyError(f"unknown logical axis {ax!r}")
        return table[ax]


def rules_for_mesh(mesh, fsdp: bool = True, fsdp_over_pods: bool = False,
                   tensor_parallel: bool = True) -> MeshRules:
    """The rules for a mesh (anything with ``axis_names`` and ``shape``,
    as ``launch/mesh.py`` makes it): data parallelism over ("pod",)
    "data", tensor parallelism over "model"; without tensor parallelism
    "model" is one more data/FSDP axis."""
    axes = tuple(mesh.axis_names)
    has_pod = "pod" in axes
    if tensor_parallel:
        dp = ("pod", "data") if has_pod else ("data",)
        tp: Optional[str] = "model"
        base_fsdp: Tuple[str, ...] = ("data",)
    else:
        dp = ("pod", "data", "model") if has_pod else ("data", "model")
        tp = None
        base_fsdp = ("data", "model")
    if not fsdp:
        fsdp_axes: Tuple[str, ...] = ()
    elif fsdp_over_pods and has_pod:
        fsdp_axes = ("pod",) + base_fsdp
    else:
        fsdp_axes = base_fsdp
    sizes = tuple(zip(axes, (int(n) for n in mesh.shape)))
    return MeshRules(dp=dp, tp=tp, fsdp=fsdp_axes, sp=("data",), sizes=sizes)


def shard(x, mesh, spec: P):
    """The reference's sharding constraint. On one card nothing is split,
    so it returns ``x``."""
    return x


class Collectives(Protocol):
    """Cross-shard operations over a shard-stacked tensor ``x`` whose
    axis 0 holds this process's shards, in shard order."""

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's slice, stacked in shard order: (S, ...)."""

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise least value over all shards (axis 0 reduced)."""

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over all shards (axis 0 reduced)."""


class LocalCollectives:
    """All shards in this process: the stack is already whole."""

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)


@dataclass(frozen=True)
class TileMesh:
    """S shards on one device, with the collectives over them."""
    shards: int
    device: torch.device
    collectives: Collectives


def tile_mesh(shards: int, device=None) -> TileMesh:
    """A mesh of ``shards`` placement slots on ``device`` (default: the
    package's). Raises on ``shards < 1``. Any S runs: unlike the
    reference, S above the device count is not an error."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    from repro_torch import resolve_device
    return TileMesh(shards=int(shards), device=resolve_device(device),
                    collectives=LocalCollectives())


@dataclass(frozen=True)
class PodMesh:
    """P data-parallel pods in this process, all on one device: the
    counterpart of the reference's "pod" mesh axis, over which its
    compressed train step (``train/compression.py``) is manual. A value
    per pod is a *pod-stacked* tensor, axis 0 the pods in order; the
    collectives reduce that axis. (A version over ``torch.distributed``,
    one pod per rank, waits for a machine with more than one card.)"""
    pods: int
    device: torch.device

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the pods (axis 0), in x's type: int32 codes sum
        in int32, as the reference's ``psum`` of int32 does."""
        return x.sum(0, dtype=x.dtype)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the pods: their sum divided by P."""
        return div(self.psum(x), float(self.pods))

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """A batch array's rows as P contiguous pod shards, viewed
        (P, rows / P, ...): the reference's ``P("pod", None, ...)``."""
        p = self.pods
        if x.shape[0] % p:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {p} pods")
        return x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))


def pod_mesh(pods: int, device=None) -> PodMesh:
    """P pods on ``device`` (default: the package's). Raises on P < 1."""
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    from repro_torch import resolve_device
    return PodMesh(pods=int(pods), device=resolve_device(device))


def strided_tile_layout(n_tiles: int, shards: int
                        ) -> Tuple[np.ndarray, int, int]:
    """Strided tile -> shard placement for a ``(T, ...)`` tile axis.

    Returns ``(perm, t_local, t_pad)``: the tile axis is padded to
    ``t_pad = shards * t_local`` positions and permuted so that padded
    position ``s * t_local + j`` holds original tile ``perm[s*t_local+j]``
    (entries >= ``n_tiles`` are padding). Shard s owns the tiles
    {t : t mod shards == s}."""
    t_local = -(-max(1, n_tiles) // shards)
    t_pad = t_local * shards
    # position s*t_local + j  <-  original tile j*shards + s
    pos = np.arange(t_pad)
    s, j = pos // t_local, pos % t_local
    perm = j * shards + s
    return perm, t_local, t_pad


def shard_put(x, mesh: TileMesh) -> torch.Tensor:
    """A host array or tensor laid out shard-major along axis 0
    (``S * t_local`` rows) on the mesh's device, viewed (S, t_local, ...):
    shard s's slice is ``out[s]``, a view of the one upload."""
    t = torch.as_tensor(x).to(mesh.device)
    s = mesh.shards
    if t.shape[0] % s:
        raise ValueError(f"axis 0 ({t.shape[0]}) is not a multiple of the "
                         f"{s} shards")
    return t.view(s, t.shape[0] // s, *t.shape[1:])

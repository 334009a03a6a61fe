"""Tile placement for the hybrid-query engine's sharded execution path —
port of the tile part of ``repro/sharding/partitioning.py`` — and the pod
axis of the compressed train step (``pod_mesh``). ``MeshRules``,
``rules_for_mesh`` and ``shard`` serve the models' partition specs, and
come with the dry run (ROADMAP queue 1 item 9, second half, part 2).

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
from typing import Protocol, Tuple

import numpy as np
import torch

from repro_torch.utils.quant import div


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

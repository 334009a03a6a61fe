from repro_torch.sharding.partitioning import (  # noqa: F401
    Collectives, LocalCollectives, PodMesh, TileMesh, pod_mesh, shard_put,
    strided_tile_layout, tile_mesh,
)

from repro_torch.sharding.partitioning import (  # noqa: F401
    Collectives, LocalCollectives, MeshRules, P, PodMesh, TileMesh, pod_mesh,
    rules_for_mesh, shard, shard_put, strided_tile_layout, tile_mesh,
)

"""Process groups and data parallelism (port of ``multimodal_mtrssm_tpu.parallel``)."""

from multimodal_mtrssm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    Mesh,
    hybrid_layout,
    ici_size,
    init_from_env,
    make_hybrid_mesh,
    make_mesh,
    mesh_rows,
    node_groups,
    replicate,
    row_range,
    shard_rows,
)

__all__ = [
    "DATA_AXIS",
    "DCN_AXIS",
    "Mesh",
    "hybrid_layout",
    "ici_size",
    "init_from_env",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_rows",
    "node_groups",
    "replicate",
    "row_range",
    "shard_rows",
]

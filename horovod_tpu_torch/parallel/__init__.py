"""Process meshes (see :mod:`.mesh`)."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Axis,
    Mesh,
    MeshSpec,
    build_mesh,
    mesh_axis_size,
    shard_batch,
)

"""Process meshes (see :mod:`.mesh`); ring attention, Ulysses and MoE
over their axes (see :mod:`.ring_attention`, :mod:`.ulysses`, :mod:`.moe`)."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Axis,
    Mesh,
    MeshSpec,
    build_mesh,
    data_sharding_spec,
    mesh_axis_size,
    shard_batch,
)

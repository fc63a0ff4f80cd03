"""Process meshes (see :mod:`.mesh`); ring attention, Ulysses and MoE
over their axes (see :mod:`.ring_attention`, :mod:`.ulysses`, :mod:`.moe`);
pipeline schedules over pp (:mod:`.pipeline`) and the parallelism plan
(:mod:`.plan`)."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Axis,
    Mesh,
    MeshSpec,
    build_mesh,
    data_sharding_spec,
    dp_pp_mesh,
    mesh_axis_size,
    shard_batch,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction,
    pipeline_1f1b_apply,
    pipeline_apply,
    pipeline_interleaved_apply,
    schedule_ticks,
    stage_stacked,
)
from horovod_tpu_torch.parallel.plan import (  # noqa: F401
    SCHEDULES,
    ParallelPlan,
    compile_step_with_plan,
    plan_from_dict,
)

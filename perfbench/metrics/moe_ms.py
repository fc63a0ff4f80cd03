"""Device milliseconds a step of the kernels launched inside the MoE
layers' forward and backward (module hooks on ``DeepseekMoE``: the router,
the sort, the shared and held experts, the combine)."""


def read(rec):
    t = rec["trace"]
    us = None if t is None else t["range_us"].get("moe")
    return us / 1e3 / t["steps"] if us else None

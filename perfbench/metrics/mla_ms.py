"""Device milliseconds a step of the kernels launched inside the MLA
blocks' forward and backward (module hooks on ``MLAttention``)."""


def read(rec):
    t = rec["trace"]
    us = None if t is None else t["range_us"].get("mla")
    return us / 1e3 / t["steps"] if us else None

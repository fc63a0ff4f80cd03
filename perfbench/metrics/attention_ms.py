"""Device milliseconds a step of the kernels launched inside the
self-attention blocks' forward and backward (module hooks)."""


def read(rec):
    t = rec["trace"]
    us = None if t is None else t["range_us"].get("attention")
    return us / 1e3 / t["steps"] if us else None

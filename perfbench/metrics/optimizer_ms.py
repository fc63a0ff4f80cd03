"""Device milliseconds a step of the kernels the optimizer's step
launched (between its step pre- and post-hooks)."""


def read(rec):
    t = rec["trace"]
    us = None if t is None else t["range_us"].get("optimizer")
    return us / 1e3 / t["steps"] if us else None

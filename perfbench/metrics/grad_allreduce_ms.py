"""Device milliseconds a step in the collectives' kernels (NCCL's, found
by name)."""


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    us = sum(v for k, v in t["kernel_us"].items() if "nccl" in k.lower())
    return us / 1e3 / t["steps"] if us else None

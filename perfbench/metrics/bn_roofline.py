"""Batch norm's least time a step over its device time: its bytes (each
input read once and each output written once, forward and backward, from
the configuration's shapes) at the card's memory bandwidth."""


def read(rec):
    t, peak, work = rec["trace"], rec["peak"], rec["work"]
    us = None if t is None else t["range_us"].get("bn")
    if not us or peak is None or "bn_bytes" not in work:
        return None
    least_s = work["bn_bytes"] / peak["bytes_per_s"]
    return 100.0 * least_s / (us / 1e6 / t["steps"])

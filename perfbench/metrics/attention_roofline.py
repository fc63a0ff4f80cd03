"""Self-attention's least time a step over its device time: the larger
of its operations at the card's dense bfloat16 peak and its bytes at the
memory bandwidth, counted over each row's valid positions."""


def read(rec):
    t, peak, work = rec["trace"], rec["peak"], rec["work"]
    us = None if t is None else t["range_us"].get("attention")
    if not us or peak is None or "attention_flops" not in work:
        return None
    least_s = max(work["attention_flops"] / peak["flops"],
                  work["attention_bytes"] / peak["bytes_per_s"])
    return 100.0 * least_s / (us / 1e6 / t["steps"])

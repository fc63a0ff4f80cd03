"""The MoE layers' least time a step over their device time (module hooks
on ``DeepseekMoE``): the larger of the shared and held experts' operations
(the held ones over the pairs the program's counter gives) at the card's
dense bfloat16 peak and their weight and token bytes at the memory
bandwidth."""


def read(rec):
    t, peak, work = rec["trace"], rec["peak"], rec["work"]
    us = None if t is None else t["range_us"].get("moe")
    if not us or peak is None or "moe_flops" not in work:
        return None
    least_s = max(work["moe_flops"] / peak["flops"],
                  work["moe_bytes"] / peak["bytes_per_s"])
    return 100.0 * least_s / (us / 1e6 / t["steps"])

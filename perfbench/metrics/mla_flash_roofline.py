"""The MLA flash forward's least time a step over its device time: the
kernel instance of 192-dim scores and 128-dim values, found by name, against
the larger of its causal operations (``2·(192 + 128)`` a pair and head) at
the card's dense bfloat16 peak and its bytes at the memory bandwidth."""

NAME = "flash_fwd_kernel_bf16<192, 128"


def read(rec):
    t, peak, work = rec["trace"], rec["peak"], rec["work"]
    if t is None or peak is None or "mla_flash_flops" not in work:
        return None
    us = sum(v for k, v in t["kernel_us"].items() if NAME in k)
    if not us:
        return None
    least_s = max(work["mla_flash_flops"] / peak["flops"],
                  work["mla_flash_bytes"] / peak["bytes_per_s"])
    return 100.0 * least_s / (us / 1e6 / t["steps"])

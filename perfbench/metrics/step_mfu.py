"""The whole step's share of the card's peak: the configuration's model
operations of every step in the measured window over the window's seconds
on the host clock, over the card's dense bfloat16 peak."""


def read(rec):
    w, peak = rec["window"], rec["peak"]
    if peak is None or not w["steps"]:
        return None
    return 100.0 * w["flops_per_step"] * w["steps"] / w["window_s"] \
        / peak["flops"]

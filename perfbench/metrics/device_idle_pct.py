"""Share of the traced window in which nothing ran on the card (nothing
when the trace saw no device activity at all)."""


def read(rec):
    t = rec["trace"]
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])

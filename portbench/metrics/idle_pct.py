"""idle_pct: the share of the traced window in which no operation ran on
the device, averaged over the cards: 100 (1 - busy / window)."""


def read(s):
    if not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

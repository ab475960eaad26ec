"""roofline_pct: the least time of the cell's operation (its operations at
the peak of the precision the configuration states for the route, or its
bytes at the bandwidth, over its cards; ``roofline.least_seconds``) over
the device's busy time a call, whatever kernels did the work."""


def read(s):
    if not s["calls"] or not s["busy_s"]:
        return None
    return 100.0 * s["least_s"] / (s["busy_s"] / s["calls"])

"""dispatch_us: the mean host-clock duration a call of the program's
outermost span of the sketch (``distributed_sketch`` on a mesh, rank 0;
else ``sketch``: ``skge.sketch_general`` from entry to return, the route's
decision and the launches, no synchronize) in the span window, in µs."""

OUTER = ("distributed_sketch", "sketch")


def read(s):
    for name in OUTER:
        spans = s["outer_span_s"].get(name)
        if spans:
            return 1e6 * sum(spans) / len(spans)
    return None

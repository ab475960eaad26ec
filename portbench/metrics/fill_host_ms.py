"""fill_host_ms: the mean host-clock duration a call of the program's
``fill`` span (``SparseSkOp.filled`` of a lazy operator: the Fisher-Yates
steps enqueued, no synchronize inside) in the span window, in ms."""


def read(s):
    spans = s["span_s"].get("fill")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""fill_ms: the mean over the window's calls of the benchmark's own span
around the explicit operator fill (``fill_sparse``), ended by a
synchronize: the host clock's time from the call into the fill to its
output being ready."""


def read(s):
    spans = s["spans"].get("fill")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

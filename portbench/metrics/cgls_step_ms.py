"""cgls_step_ms: the mean host-clock duration of the port's ``cgls.step``
spans in the span window, in ms: one CGLS step, ended by its convergence
test's synchronize."""


def read(s):
    spans = s["spans"].get("cgls_step")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

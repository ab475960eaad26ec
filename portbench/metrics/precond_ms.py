"""precond_ms: the mean over the span window's solves of the port's
``sketch_and_precondition`` span less its ``cgls.step`` spans, in ms: a
solve's host-clock time up to its first convergence test's return (the
sketches of A and b, the QR, the warm start, the initial residual, whose
device time that test waits for)."""


def read(s):
    spans = s["spans"].get("precondition")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

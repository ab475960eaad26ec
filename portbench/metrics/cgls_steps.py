"""cgls_steps: the mean over the traced window's solves of the CGLS steps
the port's solver returned (``counts["cgls_steps"]``; the ``cgls`` span
records the same count as ``steps``)."""


def read(s):
    steps = s["counts"].get("cgls_steps")
    if not steps:
        return None
    return sum(steps) / len(steps)

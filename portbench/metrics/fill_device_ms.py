"""fill_device_ms: the device time a call of the kernels whose launch lies
inside the program's ``fill`` span (each kernel tied to its runtime launch
by correlation id) in the profiled window (rank 0), in ms."""


def read(s):
    calls = s["span_calls"].get("fill")
    device = s["device_s_by_span"].get("fill")
    if not calls or not device:
        return None
    return 1e3 * device / calls

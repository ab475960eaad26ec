"""idle_in_program_pct: the share of the device's idle time in the
profiled window that overlaps one of the program's outermost spans (the
host inside the port: dispatch, fill, launches, all-reduce), each gap split
by overlap, averaged over the cards as ``idle_pct`` is. The rest is the
benchmark's own loop, the synchronize and the operator's construction."""


def read(s):
    if not s["program_spans"]:
        return None
    shares = [100.0 * p / i for i, p in zip(s["idle_s"],
                                            s["idle_in_program_s"]) if i]
    return sum(shares) / len(shares) if shares else None

"""The device's idle share of the traced steps, in %: one less the union
of its operations' intervals over the traced time."""


def idle_percent(r):
    t = r.trace
    if t is None or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

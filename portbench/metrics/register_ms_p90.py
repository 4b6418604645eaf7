"""The 90th percentile of every request's time in the window, from the
call until its top-k is on the host (closed loop, host clock), in ms:
``statistics.quantiles(n=10, method="inclusive")``."""

import statistics


def read(rec):
    if rec["kind"] != "register" or len(rec["latency_s"]) < 2:
        return None
    return statistics.quantiles(rec["latency_s"], n=10,
                                method="inclusive")[8] * 1e3

"""The device's idle time inside the program's ``register`` spans, a
request, over the profiled span: gaps in the union of device intervals
whose middle lies in such a span, the card waiting on the program's own
host code (not on the harness's ``.cpu()`` and loop), in ms."""

from portbench.harness.spans import host_wait_ms


def read(rec):
    if rec["kind"] != "register" or rec.get("trace") is None:
        return None
    return host_wait_ms(rec["trace"], "register")

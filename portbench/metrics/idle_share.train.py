"""Share of the profiled span (after the window, ``torch.profiler``) in
which no kernel, copy or fill ran on the device: one minus the union of
their intervals over the span, in %."""

from portbench.harness.trace import busy_us, span_us


def read(rec):
    if rec["kind"] != "train" or rec.get("trace") is None:
        return None
    return 100.0 * (1.0 - busy_us(rec["trace"]) / span_us(rec["trace"]))

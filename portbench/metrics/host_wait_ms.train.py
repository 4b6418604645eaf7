"""The device's idle time inside the program's ``train.dispatch`` spans
(``Trainer.train_step_multi``), a step, over the profiled dispatches:
gaps in the union of device intervals whose middle lies in such a span,
in ms."""

from portbench.harness.spans import host_wait_ms


def read(rec):
    if rec["kind"] != "train" or rec.get("trace") is None:
        return None
    return host_wait_ms(rec["trace"], "train.dispatch")

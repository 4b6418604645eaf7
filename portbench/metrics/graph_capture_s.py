"""``GraphedStep.capture_s`` of the trainer's graph: its warm-up steps and
capture, in seconds."""


def read(rec):
    return rec.get("capture_s")

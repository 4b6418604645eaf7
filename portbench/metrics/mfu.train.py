"""Model FLOPs of the window's work (FlopCounterMode over the benchmark's
reference at the cell's shapes, no recompute) over the window's seconds on
the host clock and 495 TFLOP/s a chip (the H100's dense TF32 rate, the
tensor cores' rate for the configuration's float32), in %."""

PEAK = 495e12


def read(rec):
    if rec["kind"] != "train" or rec.get("flops_per_unit") is None:
        return None
    return (100.0 * rec["flops_per_unit"] * rec["units"]
            / (rec["window_s"] * PEAK * rec["world"]))

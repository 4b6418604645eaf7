"""Optimizer-step samples completed in the window, across all ranks, over
the window's seconds (host clock, the window ending in a synchronisation)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["samples"] / rec["window_s"]

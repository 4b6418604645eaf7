"""The least time of the attention sites' work (portbench/harness/bounds.py,
at each site's shapes) over the device time of the program's own kernels,
over the profiled span, in %."""

from portbench.harness.trace import PORT_KERNEL


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None or rec.get("bound_per_unit_s") is None:
        return None
    spent = sum(b - a for n, a, b in tr["device"] if PORT_KERNEL.search(n))
    if spent <= 0:
        return None
    return 100.0 * rec["bound_per_unit_s"] * tr["units"] / (spent * 1e-6)

"""The numbers that decide ``correct``, each against its limit
(``portbench/limits/<cell>.json`` names the ones a cell compares).

Training (the program's first steps against the reference's, from the
same state and rows): ``render1_gap``, ``render1_gap_median``,
``render1_gap_mean`` and ``render1_gap_batch``, the relative L2 distance
of the first step's training render from the reference's, of the worst
window, of the median window, over windows and of the whole batch;
``loss_gap``, the largest
relative gap of a step's loss; ``grad_gap`` and ``grad_gap_median``, the
worst and the median leaf's gap between the norms of the first step's
clipped gradient (the program's read from AdamW's first moment after one
step); ``change_gap`` and ``change_gap_median``, the same of the
parameters' change over the checked steps. A leaf's gap is measured
against the reference's norm of that leaf or of the median leaf, whichever
is larger; leaves whose reference gradient is under a thousandth of the
median leaf's are left out (their moves are round-off).

Registration (each checked request's answers against the reference's on
the same windows and tiles): ``render_gap``, ``render_gap_median`` and
``render_gap_mean``, ``render_gap_batch``, the relative L2 distance of the render from the
reference's, as in training; the match judged on the
program's own render, against the float32 distances from that render to
every tile: ``rank_gap``, the widest gap by which a returned tile's
distance lies above the k-th best, and ``dist_gap``, the widest departure
of a reported distance from that tile's.
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch

SMALL_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def leaf_gaps(prog: dict, ref: dict, p0: dict) -> tuple:
    """({leaf: gap of the first gradient's norm}, {leaf: gap of the
    change's norm}) over the leaves kept; prog and ref: {"grad1": {name:
    tensor}, "p_end": {name: tensor}}; p0 the state both started from."""
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med_g = _median(list(g_ref.values()))
    keep = [n for n in g_ref if g_ref[n] >= SMALL_LEAF * med_g]
    grad = {n: abs(g_prog[n] - g_ref[n]) / max(g_ref[n], med_g) for n in keep}
    d_ref = _norms({n: ref["p_end"][n].double() - p0[n].double() for n in keep})
    d_prog = _norms({n: prog["p_end"][n].double() - p0[n].double() for n in keep})
    med_d = _median(list(d_ref.values()))
    change = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med_d) for n in keep}
    return grad, change


def train_numbers(prog: dict, ref: dict, p0: dict) -> dict:
    """prog and ref: {"losses": [...], "render1": tensor, "grad1": {name:
    tensor}, "p_end": {name: tensor}}; p0 the state both started from."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad, change = leaf_gaps(prog, ref, p0)
    grad_leaf, change_leaf = list(grad.values()), list(change.values())
    render = {k.replace("render", "render1"): v for k, v in
              _render_gaps(prog["render1"], ref["render1"]).items()}
    return {**render, "loss_gap": max(gaps), "grad_gap": max(grad_leaf),
            "grad_gap_median": _median(grad_leaf),
            "change_gap": max(change_leaf),
            "change_gap_median": _median(change_leaf)}


def _render_gaps(render, ref_render) -> dict:
    """The relative L2 distance of ``render`` from ``ref_render``: the worst
    window's (``render_gap``), the median window's (the lower of the two
    middle ones), the mean over windows and the whole batch's; 1 where the
    program did not render every window."""
    b = ref_render.shape[0]
    if render is None or render.shape != ref_render.shape:
        return {"render_gap": 1.0, "render_gap_median": 1.0,
                "render_gap_mean": 1.0, "render_gap_batch": 1.0}
    diff = (render.double() - ref_render.double()).reshape(b, -1)
    ref = ref_render.double().reshape(b, -1)
    each = torch.linalg.vector_norm(diff, dim=1) / torch.linalg.vector_norm(ref, dim=1)
    return {"render_gap": float(each.max()),
            "render_gap_median": float(each.median()),
            "render_gap_mean": float(each.mean()),
            "render_gap_batch": float(torch.linalg.vector_norm(diff)
                                      / torch.linalg.vector_norm(ref))}


def register_numbers(render, idx, dist, ref_render, own_dist) -> dict:
    """render (B, ...) and top-k (idx, dist) (B, k) of the program;
    ref_render the reference's render of the same windows, own_dist the
    reference's float32 distances from the program's own render to every
    tile (B, n), so that the match is judged apart from the render."""
    k = idx.shape[1]
    best = torch.sort(own_dist.double(), dim=1).values[:, :k]
    chosen = torch.gather(own_dist.double(), 1, idx.long())
    return {**_render_gaps(render, ref_render),
            "rank_gap": float((chosen - best).max()),
            "dist_gap": float((dist.double() - chosen).abs().max())}


def worst(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def load_limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "portbench", "limits", f"{cell}.json")) as f:
        return json.load(f)


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; the numbers are printed on standard error, last."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    for name, v in out.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return ok, out

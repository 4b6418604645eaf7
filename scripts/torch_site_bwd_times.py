"""Time a kernel of the port through its wrapper on one CUDA card: the
fused site backward (csrc/fused_site_bwd.cu, ``--kernel site_bwd``, the
default) at the four shapes a flagship training step gives it
(``chip_smoke.TRAIN_SITE_SITES``); the window scatter-add backward
(csrc/lattice_windows.cu, ``--kernel windows_bwd``) at the shapes
``chip_smoke``'s phase 25 times it: every training shape of the windowed
bias and the pyramid's SCA 56 (rows of ``chip_smoke.WINDOW_SITES``), with
``index_add_`` of the same cotangent rows into float32 beside it; or the
head-folded fused site (csrc/fused_site_fold_heads.cu, ``--kernel
fold_heads``): ``fused_site_fold_heads`` at phase 22's serving shapes
(``chip_smoke.SITE_SITES``) beside ``fused_site_wide_prefetch`` and
``fused_site``, its logsumexp instance at the training shapes
(``TRAIN_SITE_SITES``) beside ``fused_site_lse``, both with PyTorch's
attention (the bias as a mask, ``chip_smoke.sdpa_ms``) beside them, and the
logsumexp instance at the SCA G=4 ch 8 shape for B*V = 2, 4, ... 12 to show
how its time steps with the grid. Each fold line names the path the
wrapper takes (``fused_site_fold.heads_plan``; a checkout without it has
the ring only), the grid's blocks, the blocks one SM holds (the library's
``fused_site_fold_heads_occupancy``, from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; "-" where the library
does not export it) and the waves they make. ``--kernel prefetch`` times
the fused sites of the whole-table template (csrc/site_whole.cuh) at
phases 18 and 22's shapes (``chip_smoke.SITE_SITES`` and, where
chip_smoke has it, ``PREFETCH_RING_SITE``): the window-prefetch site #10
(csrc/fused_site_wide_prefetch.cu), the wide site #7
(csrc/fused_site_wide.cu), the row-folded site #13
(csrc/fused_site_fold_rows.cu) and the head-folded #11 beside
``fused_site`` and SDPA with the mask; the logsumexp instances (#8-wide,
``fused_site_lse``, #12) at ``TRAIN_SITE_SITES``; then #10, #7 and #13 at
the SCA G=4 ch 8 shape for B*V = 2, 4, ... 12. Each line names the plans
of #10 (``fused_site_wide.prefetch_plan``; the ring only in a checkout
without it), #7 (``wide_plan``), #13 (``fused_site_fold.rows_plan``) and
``fused_site`` (``fused_site.site_plan``; a checkout without them has
their fixed blocks of 128 queries): path, heads and queries a block,
shared memory, grid blocks, blocks an SM (the libraries' occupancy
queries) and waves, and the run ends with each kernel's loss, launches x
(time - bound) summed over a serving forward or a ``fused_bwd`` step. A
checkout with ``wide_plan``
also times #7 and #8-wide forced onto path "raw" and #11 and #12 at the
strips ``fused_site_fold.wave_strip`` gives them. ``--kernel bias_bwd`` times both
bias backwards (csrc/bias_bwd_rows.cuh) at phases 8, 12 and 18's shapes
beside ``grid_sampler_2d_backward``; ``--kernel bias_fwd`` times both wide
bias forwards (csrc/bias_fwd_rows.cuh: ``lattice_bias_wide`` and
``lattice_bias_wide_prefetch``) at phases 12 and 18's shapes beside
``F.grid_sample``, each line with the plan (``lattice_bias.fwd_plan``;
the kernels before it where the checkout has none), and their sums over
one forward of each route.

    python3 scripts/torch_site_bwd_times.py [--kernel K] [--root DIR] [--sass]

``--root`` names the checkout whose ``bevrender_tpu_torch`` is built and
timed (default: this one): for example an older commit unpacked with
``git archive`` into a git-ignored directory, or a copy of the tree with
the kernel's source edited. To compare two builds, run the script once for
each back to back on one card, in the order A, B, B, A. The inputs are
chip_smoke's with fixed seeds (``site_inputs``; for the windows those of
its phase 25), the same for every root; each time is the least of three
``chip_smoke.queued_ms`` readings of five wrapper calls (the zero-fills
and scratch of its outputs included). ``--sass`` also prints the build's
``ptxas`` register report and opcode counts from its SASS: for the site
backward, each shared-memory atomic, shuffle and mma opcode of its ``ch =
8`` kernel; for the windows backward, each atomic and reduction opcode of
every backward kernel, and how many of them act on floats; for the folded
and the prefetch site, each kernel's registers (``cuobjdump -res-usage``)
and its atomic, mma, asynchronous-copy and barrier opcodes; for the bias
forwards each kernel's registers, loop lengths and memory opcodes. The windows
also print the largest bin of their starts (keys sharing one (g, ms, ys))
and the share of keys whose ms is clipped to the table's first or last
start. The last line is one JSON object with the card and the times.
"""

from __future__ import annotations

import argparse
import collections
import functools
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# one SASS line's opcode, after its address and any predicate
SASS_OP = r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"


def sass_functions(lib: Path) -> dict:
    """{mangled kernel name: Counter of its SASS opcodes} of a library."""
    from bevrender_tpu_torch.ops.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs = {}
    for f in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, rest = f.partition("\n")
        funcs[name.strip()] = collections.Counter(
            m.group(1) for m in map(lambda ln: re.match(SASS_OP, ln),
                                    rest.splitlines()) if m)
    return funcs


def sass_counts(lib: Path) -> dict:
    """Opcode counts of interest in the ch = 8 instance of the site
    backward kernel."""
    ops = next(c for n, c in sass_functions(lib).items()
               if "site_bwd_kernel" in n and "ILi8E" in n)
    keep = ("ATOMS", "ATOM.", "RED", "SHFL", "HMMA", "MOVM")
    return {k: v for k, v in sorted(ops.items()) if k.startswith(keep)}


def windows_sass(lib: Path) -> dict:
    """Atomic and reduction opcodes of every windows backward kernel (a
    name with "bwd"), and the number of them that act on floats (an F32
    type, or a compare-and-swap, which is how sm_90a adds a float into
    shared memory)."""
    res = {}
    for name, ops in sass_functions(lib).items():
        if "bwd" not in name:
            continue
        atom = {k: v for k, v in sorted(ops.items())
                if k.startswith(("ATOM", "RED"))}
        res[name] = dict(ops=atom, float_atomics=sum(
            v for k, v in atom.items() if "F32" in k or "CAS" in k))
    return res


def registers(lib: Path) -> dict:
    """{mangled kernel name: registers a thread} of a library, from
    ``cuobjdump -res-usage`` (the build's ptxas report is empty when the
    library was already built)."""
    from bevrender_tpu_torch.ops.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function (\S+):\s*\n\s*REG:(\d+)", out)}


def fold_sass(lib: Path) -> dict:
    """Atomic, mma, asynchronous-copy and barrier opcodes of every kernel
    of a fused site's library."""
    keep = ("ATOM", "RED", "HMMA", "LDGSTS", "LDGDEPBAR", "DEPBAR", "BAR")
    return {name: {k: v for k, v in sorted(ops.items())
                   if k.startswith(keep)}
            for name, ops in sass_functions(lib).items()}


def sass_loops(lib: Path) -> dict:
    """Per kernel of a library: its SASS instruction count, the length in
    instructions of each loop (a branch back to an earlier address, over 20
    instructions, inner loops first) and its local-memory loads and stores
    (spills)."""
    from bevrender_tpu_torch.ops.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    res = {}
    for f in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, rest = f.partition("\n")
        ins = [(int(m.group(1), 16), m.group(2)) for m in map(
            lambda ln: re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln),
            rest.splitlines()) if m]
        loops = []
        for addr, op in ins:
            back = re.search(r"BRA\b.*?0x([0-9a-f]+)", op)
            if back and int(back.group(1), 16) < addr:
                length = (addr - int(back.group(1), 16)) // 16 + 1
                if length > 20:
                    loops.append(length)
        res[name.strip()] = dict(
            instructions=len(ins), loops=sorted(loops),
            local=sum(1 for _, op in ins if re.search(r"\b(LDL|STL)\b", op)))
    return res


def site_bwd_times(cs, card: str, result: dict) -> None:
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops import kernels

    bf = torch.bfloat16
    for i, (name, B, G, ch, N, Wt, per_step) in enumerate(
            cs.TRAIN_SITE_SITES):
        H, W = cs.H, cs.W
        table, k_pos, q, k, v = cs.site_inputs(60 + i, B, G, ch, N, Wt)
        scale = ch ** -0.5
        gen = torch.Generator(device="cuda").manual_seed(160 + i)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        kargs = da._kernel_args(table, k_pos, H, W) + (
            q.to(bf).contiguous(), k.to(bf).contiguous(),
            v.to(bf).contiguous())
        with torch.no_grad():
            out, lse = kernels.fused_site.fused_site_lse_cuda(*kargs, H, W,
                                                              scale)
        dsum = (dout * out).sum(-1)

        def bwd(kargs=kargs, dout=dout, lse=lse, dsum=dsum, scale=scale):
            return kernels.fused_site_bwd.fused_site_bwd_cuda(
                *kargs, dout, lse, dsum, H, W, scale)

        ms = min(cs.queued_ms(bwd, 5) for _ in range(3))
        result["ms"][name] = ms
        print(f"{name} (x{per_step} a step): {ms:.4f} ms [{card}]",
              flush=True)
        del table, k_pos, q, k, v, kargs, dout, lse, dsum, out
        torch.cuda.empty_cache()


def windows_bwd_times(cs, card: str, result: dict) -> None:
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops.kernels import lattice_windows as lw

    result["starts"], result["library_ms"] = {}, {}
    for i, (name, Hs, B, G, N, Wt, _, _, per_bwd) in enumerate(
            cs.WINDOW_SITES):
        if not (per_bwd or name.startswith("pyramid_sca56")):
            continue  # phase 25 times #15 at these shapes only
        table, k_pos, _ = cs.bias_inputs(130 + i, B, G, N, Wt, Hs,
                                         cs.SITE_TABLE_STDS[0])
        ys, ms, _, _ = da.lattice_geometry(table.shape, k_pos, Hs, Hs)
        ys, ms = ys.contiguous(), ms.contiguous()
        t3 = da.lattice_t3(table, Hs, torch.bfloat16)
        h1 = Hs + 1
        gen = torch.Generator(device="cuda").manual_seed(150 + i)
        gout = torch.randn((B, G, N, 3, h1, t3.shape[3]), generator=gen,
                           device="cuda").bfloat16()

        def bwd(gout=gout, ys=ys, ms=ms, shape=t3.shape):
            return lw.lattice_windows_bwd_cuda(gout, ys, ms, shape,
                                               torch.bfloat16)

        t = min(cs.queued_ms(bwd, 5) for _ in range(3))
        G, Y, m_max, WH = t3.shape
        rows = lw.window_rows(ys, ms, h1, Y, m_max).reshape(-1)
        gf = gout.reshape(-1, WH).float()
        buf = torch.zeros(G * Y * m_max, WH, device="cuda")
        lib = min(cs.queued_ms(lambda: buf.index_add_(0, rows, gf), 5)
                  for _ in range(3))
        starts = cs.window_starts(ys, ms, t3.shape, h1)
        result["ms"][name] = t
        result["library_ms"][name] = lib
        result["starts"][name] = starts
        print(f"{name} (x{per_bwd} a step): {t:.4f} ms, index_add_ "
              f"{lib:.4f} ms; largest bin "
              f"{starts['largest_bin']} keys, clipped ms "
              f"{starts['clipped_share']:.4f} of {starts['keys']} [{card}]",
              flush=True)
        del table, k_pos, ys, ms, t3, gout, rows, gf, buf
        torch.cuda.empty_cache()


def fold_plan(cs, fold, lib, n_sm, B, G, ch, Wt) -> dict:
    """Path, grid blocks, blocks an SM holds and waves of a folded site at
    chip_smoke's H, W and heads per group."""
    H, W, Hpg = cs.H, cs.W, cs.HPG
    if hasattr(fold, "heads_plan"):
        path, queries, threads, smem = fold.heads_plan(Hpg, Wt, H, W, ch)
    else:  # a checkout before the whole-table path: the ring only
        path, queries, threads = "ring", fold.THREADS, fold.THREADS
        smem = fold.fold_ring(Hpg, Wt, H, W, ch)[3]
    blocks = -(-(H * W) // queries) * B * G
    try:
        occupancy = lib.fused_site_fold_heads_occupancy
    except AttributeError:
        return dict(path=path, blocks=blocks, per_sm=None, waves=None)
    per_sm = occupancy(int(path == "whole"), ch, Hpg, threads, smem)
    if per_sm <= 0:
        raise SystemExit(f"occupancy query failed: {per_sm}")
    return dict(path=path, blocks=blocks, per_sm=per_sm,
                waves=-(-blocks // (per_sm * n_sm)))


def fold_heads_times(cs, card: str, result: dict) -> None:
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    fold, bf = kernels.fused_site_fold, torch.bfloat16
    lib = build.load_library("fused_site_fold_heads")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    H, W = cs.H, cs.W
    best = lambda fn: min(cs.queued_ms(fn, 5) for _ in range(3))  # noqa: E731
    _, B4, G4, ch4, N4, Wt4, _ = cs.TRAIN_SITE_SITES[2]
    runs = ([("heads", *site, 110 + i) for i, site in enumerate(cs.SITE_SITES)]
            + [("lse", *site, 110 + i)
               for i, site in enumerate(cs.TRAIN_SITE_SITES)]
            + [("lse", f"sweep_bv{b}_g{G4}_ch{ch4}", b, G4, ch4, N4, Wt4, 0,
                112) for b in range(2, 13, 2)])
    for tag, name, B, G, ch, N, Wt, per, seed in runs:
        table, k_pos, q, k, v = cs.site_inputs(seed, B, G, ch, N, Wt)
        scale = ch ** -0.5
        kargs = da._kernel_args(table, k_pos, H, W) + tuple(
            x.to(bf).contiguous() for x in (q, k, v))
        geo, qkv = kargs[:7], kargs[8:]
        if tag == "heads":
            fn = lambda: fold.fused_site_fold_heads_cuda(  # noqa: E731
                *geo, *qkv, H, W, scale)
            sibs = {"fused_site_wide_prefetch": lambda: (
                kernels.fused_site_wide.fused_site_wide_prefetch_cuda(
                    *geo, *qkv, H, W, scale)),
                    "fused_site": lambda: kernels.fused_site.fused_site_cuda(
                        *kargs, H, W, scale)}
        else:
            fn = lambda: fold.fused_site_fold_heads_lse_cuda(  # noqa: E731
                *geo, *qkv, H, W, scale)
            sibs = {"fused_site_lse": lambda: (
                kernels.fused_site.fused_site_lse_cuda(*kargs, H, W, scale))}
        rec = dict(fold_plan(cs, fold, lib, n_sm, B, G, ch, Wt), ms=best(fn))
        rec.update({f"{n}_ms": best(f) for n, f in sibs.items()})
        if not name.startswith("sweep"):
            bias = da.lattice_bias_plain(table.bfloat16().float(), k_pos, H,
                                         W, torch.float32)
            rec["sdpa_ms"] = min(cs.sdpa_ms(q, k, v, bias, scale, 5)
                                 for _ in range(3))
            del bias
        result["ms"][f"{tag} {name}"] = rec
        print(f"{tag} {name} (x{per}): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v if v is not None else '-'}"
                          for k, v in rec.items()) + f" [{card}]", flush=True)
        del table, k_pos, q, k, v, kargs, geo, qkv
        torch.cuda.empty_cache()


def prefetch_plan(cs, wide, lib, n_sm, B, G, ch, Wt, side) -> dict:
    """Path, queries a block, grid blocks, blocks an SM holds and waves of
    ``fused_site_wide_prefetch`` at a site of BEV side x side with
    chip_smoke's heads per group (one head a block on either path)."""
    Ht = 2 * side - 1
    if hasattr(wide, "wide_plan"):  # #10's whole path takes #7's plan
        path, queries, threads, smem = wide.prefetch_plan(
            Ht, Wt, side, side, ch, B * G * cs.HPG, n_sm)
    elif hasattr(wide, "prefetch_plan"):
        path, queries, threads, smem = wide.prefetch_plan(Ht, Wt, side, side,
                                                          ch)
    else:  # a checkout before the whole-table path: the ring only
        path, queries, threads = "ring", wide.THREADS, wide.THREADS
        smem = wide.prefetch_ring(Ht, Wt, side, side, ch)[3]
    blocks = -(-(side * side) // queries) * B * G * cs.HPG
    rec = dict(path=path, strip=queries, smem=smem, blocks=blocks,
               per_sm=None, waves=None)
    if hasattr(lib, "fused_site_wide_prefetch_occupancy"):
        rec["per_sm"] = lib.fused_site_wide_prefetch_occupancy(
            int(path == "whole"), ch, threads, smem)
        if rec["per_sm"] <= 0:
            raise SystemExit(f"occupancy query failed: {rec['per_sm']}")
        rec["waves"] = -(-blocks // (rec["per_sm"] * n_sm))
    return rec


def site_plan(kernels, kernel, n_sm, B, G, Hpg, ch, Wt, side) -> dict:
    """The plan of ``fused_site`` and its logsumexp instance (``kernel``
    "site"), ``fused_site_wide`` ("wide") or ``fused_site_fold_rows``
    ("rows") at a site of BEV side x side: path, heads and queries a block,
    grid blocks, blocks an SM (the card's occupancy query) and waves. A
    checkout before they became instances of csrc/site_whole.cuh (no
    ``site_plan`` / ``wide_plan`` / ``rows_plan``) gets its fixed 128-query
    blocks: one head a block with the table staged ("whole") or reading the
    raw table ("l1"), or every head a block with the tables staged
    ("fold"), and for the latter its library's occupancy where it has
    one."""
    from bevrender_tpu_torch.ops.kernels import build
    from bevrender_tpu_torch.ops.kernels._launch import padded_width

    site = kernels.fused_site
    wide, fold = kernels.fused_site_wide, kernels.fused_site_fold
    Ht, M = 2 * side - 1, side * side
    Xp = padded_width(Wt)
    if kernel == "site" and hasattr(site, "site_plan"):
        p = site.site_plan(B, G, Hpg, Ht, Xp, side, side, ch, n_sm)
        return dict(p._asdict(), per_sm=site.site_blocks_per_sm(p, ch))
    if kernel == "wide" and hasattr(wide, "wide_plan"):
        p = wide.wide_plan(Ht, Wt, side, side, ch, B * G * Hpg, n_sm)
        return dict(p._asdict(), per_sm=wide.wide_blocks_per_sm(p, ch))
    if kernel == "rows" and hasattr(fold, "rows_plan"):
        p = fold.rows_plan(B, G, Hpg, Ht, Xp, side, side, ch, n_sm)
        return dict(p._asdict(), per_sm=fold.rows_blocks_per_sm(p, ch))
    heads = Hpg if kernel == "rows" else 1
    blocks = -(-M // 128) * B * G * Hpg // heads
    rec = dict(path=dict(site="whole", wide="l1", rows="fold")[kernel],
               heads=heads, strip=128, blocks=blocks, per_sm=None,
               waves=None)
    if kernel == "rows" and hasattr(fold, "rows_smem"):
        lib = build.load_library("fused_site_fold_rows")
        rec["per_sm"] = lib.fused_site_fold_rows_occupancy(
            ch, Hpg, fold.rows_smem(Hpg, Ht, Xp, ch))
        rec["waves"] = -(-blocks // (rec["per_sm"] * n_sm))
    return rec


def wave_ms(best, kernels, which, args, B, G, Hpg, Ht, Wt, N, side, ch,
            scale, n_sm):
    """#11 (``which`` "heads") or #12 ("heads_lse") on its whole-table path
    with the strip ``fused_site_fold.wave_strip`` gives its grid (the rule
    of #7, #8-wide, #10 and #13), called through its C entry point; None
    where that strip is the one its wrapper takes, or the checkout has no
    ``wave_strip``."""
    import torch

    from bevrender_tpu_torch.ops.kernels._launch import call, padded_width

    fold = kernels.fused_site_fold
    if not hasattr(fold, "wave_strip"):
        return None
    Xp, M = padded_width(Wt), side * side
    path, S, _, smem = fold.heads_plan(Hpg, Wt, side, side, ch)
    if path != "whole":
        return None
    per_sm = fold.blocks_an_sm(smem, 2)  # the launch bounds' 2 blocks an SM
    S2 = fold.wave_strip(Hpg, M, B * G, per_sm, n_sm, fold.MAX_THREADS)
    if S2 == S:
        return None
    dev = args[0].device
    out = torch.empty((B, G, Hpg, M, ch), dtype=torch.float32, device=dev)
    lse = torch.empty((B, G, Hpg, M), dtype=torch.float32, device=dev)
    lib, fn = "fused_site_fold_heads", f"fused_site_fold_{which}_launch"
    tail = (B, G, Hpg, Ht, Wt, Xp, N, side, side, S2, ch, float(scale))
    outs = (out, lse) if which == "heads_lse" else (out,)
    return best(lambda: call(lib, fn, (*args, *outs, *tail))), S2


# the kernel times of ``prefetch_times`` summed into losses: #7 or #8-wide
# ("ms"), #10, #13, ``fused_site``, #11, ``fused_site_lse``, #12
LOSS_KEYS = ("ms", "prefetch_ms", "fold_rows_ms", "fused_site_ms",
             "fold_heads_ms", "fused_site_lse_ms", "fold_heads_lse_ms")


def prefetch_times(cs, card: str, result: dict) -> None:
    """The site kernels of the whole-table template and their siblings:
    #10 (``fused_site_wide_prefetch``), #7 (``fused_site_wide``), #13
    (``fused_site_fold_rows``), #11 (``fused_site_fold_heads``),
    ``fused_site`` and SDPA with the mask at phase 18's shapes
    (SITE_SITES and PREFETCH_RING_SITE, where chip_smoke has it); the
    logsumexp instances #8-wide (``fused_site_wide_lse``),
    ``fused_site_lse`` and #12 (``fused_site_fold_heads_lse``) at the
    training shapes (TRAIN_SITE_SITES); #10, #7 and #13 at the SCA G=4 ch 8
    shape for B*V = 2, 4, ... 12. Each line prints the plans of #10, #7,
    #13 and ``fused_site`` (path, heads and queries a block, blocks,
    blocks an SM, waves); the last sums each kernel's launches x (time -
    bound) over a serving forward or a ``fused_bwd`` step (``LOSS_KEYS``,
    ``forward_sums``). Where the checkout has ``wide_plan``, #7 and
    #8-wide are also timed on
    path "raw" where they take "whole" (``raw_ms``), and #11 and #12 at the
    strips ``wave_strip`` would give them (``*_wave_ms``, with the strip)
    where those differ from their own."""
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    wide, fold, bf = kernels.fused_site_wide, kernels.fused_site_fold, (
        torch.bfloat16)
    lib = build.load_library("fused_site_wide_prefetch")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    best = lambda fn: min(cs.queued_ms(fn, 5) for _ in range(3))  # noqa: E731
    new = hasattr(wide, "wide_plan")
    sums = collections.defaultdict(float)
    Hpg = cs.HPG
    _, B4, G4, ch4, N4, Wt4, _ = cs.SITE_SITES[2]
    ring = getattr(cs, "PREFETCH_RING_SITE", None)
    runs = ([("serve", *site, cs.H, 80 + i)
             for i, site in enumerate(cs.SITE_SITES)]
            + ([("serve", *ring[:-1], ring[-1], 84)] if ring else [])
            + [("lse", *site, cs.H, 90 + i)
               for i, site in enumerate(cs.TRAIN_SITE_SITES)]
            + [("sweep", f"sweep_bv{b}_g{G4}_ch{ch4}", b, G4, ch4, N4, Wt4, 0,
                cs.H, 82) for b in range(2, 13, 2)])
    for tag, name, B, G, ch, N, Wt, per, side, seed in runs:
        table, k_pos, q, k, v = cs.site_inputs(seed, B, G, ch, N, Wt,
                                               side=side)
        scale = ch ** -0.5
        Ht = 2 * side - 1
        kargs = da._kernel_args(table, k_pos, side, side) + tuple(
            x.to(bf).contiguous() for x in (q, k, v))
        geo, qkv = kargs[:7], kargs[8:]
        fits = da.site_route(table.shape, side, side, ch) == "whole"
        folds = fold.rows_fit(Hpg, Ht, kargs[7], side, ch)
        rec = {"wide": site_plan(kernels, "wide", n_sm, B, G, Hpg, ch, Wt,
                                 side)}
        if tag == "lse":
            rec["ms"] = best(lambda: wide.fused_site_wide_lse_cuda(
                *geo, *qkv, side, side, scale))
            if new and rec["wide"]["path"] == "whole":
                rec["raw_ms"] = best(lambda: wide.fused_site_wide_lse_cuda(
                    *geo, *qkv, side, side, scale, path="raw"))
            rec["site"] = site_plan(kernels, "site", n_sm, B, G, Hpg, ch,
                                    Wt, side)
            rec["fused_site_lse_ms"] = best(
                lambda: kernels.fused_site.fused_site_lse_cuda(
                    *kargs, side, side, scale))
            rec["fold_heads_lse_ms"] = best(
                lambda: fold.fused_site_fold_heads_lse_cuda(
                    *geo, *qkv, side, side, scale))
            w = wave_ms(best, kernels, "heads_lse", geo + qkv, B, G, Hpg, Ht,
                        Wt, N, side, ch, scale, n_sm)
            if w:
                rec["fold_heads_lse_wave_ms"], rec["fold_heads_lse_wave"] = w
        else:
            rec["prefetch"] = prefetch_plan(cs, wide, lib, n_sm, B, G, ch, Wt,
                                            side)
            rec["prefetch_ms"] = best(
                lambda: wide.fused_site_wide_prefetch_cuda(
                    *geo, *qkv, side, side, scale))
            rec["ms"] = best(lambda: wide.fused_site_wide_cuda(
                *geo, *qkv, side, side, scale))
            if new and rec["wide"]["path"] == "whole":
                rec["raw_ms"] = best(lambda: wide.fused_site_wide_cuda(
                    *geo, *qkv, side, side, scale, path="raw"))
            if folds:
                rec["rows"] = site_plan(kernels, "rows", n_sm, B, G, Hpg, ch,
                                        Wt, side)
                rec["fold_rows_ms"] = best(
                    lambda: fold.fused_site_fold_rows_cuda(
                        *kargs, side, side, scale))
            if tag == "serve":
                if fits:
                    rec["site"] = site_plan(kernels, "site", n_sm, B, G, Hpg,
                                            ch, Wt, side)
                    rec["fused_site_ms"] = best(
                        lambda: kernels.fused_site.fused_site_cuda(
                            *kargs, side, side, scale))
                if fold.heads_fit(Hpg, Wt, side, side, ch) and fold.heads_plan(
                        Hpg, Wt, side, side, ch)[0] == "whole":
                    rec["fold_heads_ms"] = best(
                        lambda: fold.fused_site_fold_heads_cuda(
                            *geo, *qkv, side, side, scale))
                    w = wave_ms(best, kernels, "heads", geo + qkv, B, G, Hpg,
                                Ht, Wt, N, side, ch, scale, n_sm)
                    if w:
                        rec["fold_heads_wave_ms"], rec["fold_heads_wave"] = w
        if tag != "sweep":
            bias = da.lattice_bias_plain(table.bfloat16().float(), k_pos,
                                         side, side, torch.float32)
            rec["sdpa_ms"] = min(cs.sdpa_ms(q, k, v, bias, scale, 5)
                                 for _ in range(3))
            del bias
        if per:  # launches x (time - bound) over a forward or a step
            bound = cs.site_bound(B, G, ch, N, Wt, lse=tag == "lse",
                                  side=side)[0]
            for key in LOSS_KEYS:
                if key in rec:
                    sums[f"{tag} {key} loss"] += per * (rec[key] - bound)
        result["ms"][f"{tag} {name}"] = rec
        print(f"{tag} {name} (x{per}): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v if v is not None else '-'}"
                          for k, v in rec.items()) + f" [{card}]", flush=True)
        del table, k_pos, q, k, v, kargs, geo, qkv
        torch.cuda.empty_cache()
    result["forward_sums"] = dict(sums)
    print("losses, launches x (time - bound) over a serving forward (serve) "
          "or a fused_bwd step (lse): " + ", ".join(
              f"{k} {v:.4f}" for k, v in sums.items()) + f" [{card}]",
          flush=True)


def bias_bwd_plan(cs, bwd, lib, n_sm, wide, B, G, N, Wt, H) -> dict:
    """Rows a band, bands, key runs, shared memory, grid blocks, blocks an
    SM holds and waves of one bias backward launch at a site of BEV H x H
    with chip_smoke's heads per group: ``lattice_bias_bwd.plan`` where the
    checkout has it, else the sizing of the kernels before it (one head's
    whole padded table, or bands of as many rows as fit, and ``_chunks``).
    Blocks an SM from the library's ``<kernel>_occupancy(W, smem)``; "-"
    where the library does not export it."""
    from bevrender_tpu_torch.ops.kernels._launch import (
        PAD, SMEM_PER_BLOCK, padded_width)

    Hpg, Ht = cs.HPG, 2 * H - 1
    Yp, Xp = Ht + 2 * PAD, padded_width(Wt)
    if hasattr(bwd, "plan"):
        p = bwd.plan(B, G, Hpg, Ht, Wt, N, H, H, n_sm)
        rows, bands, runs, smem = p.rows, p.bands, p.runs, p.smem
    else:
        if wide:
            bands = -(-Yp // (SMEM_PER_BLOCK // (4 * Xp)))
            rows = -(-Yp // bands)
            smem = rows * Xp * 4
        else:
            bands, rows, smem = 1, Yp, Yp * Xp * 6
        chunks = bwd._chunks(bands * B * G * Hpg, N, n_sm)
        runs = -(-N // -(-N // chunks))
    blocks = B * G * Hpg * bands * runs
    rec = dict(rows=rows, bands=bands, runs=runs, smem=smem, blocks=blocks,
               per_sm=None, waves=None)
    name = "lattice_bias_wide_bwd" if wide else "lattice_bias_bwd"
    if hasattr(lib, f"{name}_occupancy"):
        rec["per_sm"] = getattr(lib, f"{name}_occupancy")(H, smem)
        if rec["per_sm"] <= 0:
            raise SystemExit(f"occupancy query failed: {rec['per_sm']}")
        rec["waves"] = -(-blocks // (rec["per_sm"] * n_sm))
    return rec


def bias_bwd_times(cs, card: str, result: dict) -> None:
    """#3 (``lattice_bias_bwd``) and #6 (``lattice_bias_wide_bwd``) at the
    shapes chip_smoke's phases 8, 12 and 18 time them, with those phases'
    seeds: every training shape (``TRAIN_BIAS_SITES``) on both kernels and
    every pyramid shape (``PYR_BIAS_SITES``) on the kernel of its route,
    #6 also at TSA 56; each shape's plan (``bias_bwd_plan``) and, once a
    shape, ``grid_sampler_2d_backward`` over the same cotangent
    (``chip_smoke.grid_sample_args``: bilinear, zero padding,
    align_corners, one call for every head) as the library time."""
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops.kernels import build

    bwd = __import__("bevrender_tpu_torch.ops.kernels.lattice_bias_bwd",
                     fromlist=["x"])
    libs = {w: build.load_library("lattice_bias_wide_bwd" if w
                                  else "lattice_bias_bwd")
            for w in (False, True)}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    best = lambda fn: min(cs.queued_ms(fn, 5) for _ in range(3))  # noqa: E731
    shapes = []
    for i, (name, B, G, _, N, Wt, per) in enumerate(cs.TRAIN_BIAS_SITES):
        shapes.append((f"train_{name}", B, G, N, Wt, cs.H, per, (False, True),
                       ("site", 40 + i, 50 + i)))
    for i, (name, H, B, G, N, Wt) in enumerate(cs.PYR_BIAS_SITES):
        wide = da.bias_route((G, cs.HPG, 2 * H - 1, Wt), H, H) == "wide"
        routes = (True,) if wide else (
            (False, True) if name in cs.PYR_WIDE_SITES else (False,))
        shapes.append((f"pyramid_{name}", B, G, N, Wt, H,
                       cs.PYR_BIAS_PER_FORWARD[name] // 2, routes,
                       ("bias", 70 + i, None)))
    for name, B, G, N, Wt, H, per, routes, (kind, s1, s2) in shapes:
        if kind == "site":
            table, k_pos, *_ = cs.site_inputs(s1, B, G, 4, N, Wt,
                                              cs.SITE_TABLE_STDS[0])
            gen = torch.Generator(device="cuda").manual_seed(s2)
            gout = torch.randn(B, G, cs.HPG, N, H * H, generator=gen,
                               device="cuda").bfloat16()
        else:
            table, k_pos, gout = cs.bias_inputs(s1, B, G, N, Wt, H,
                                                cs.SITE_TABLE_STDS[0])
        args = da._kernel_args(table, k_pos, H, H)
        rec = {}
        for wide in routes:
            call = (bwd.lattice_bias_wide_bwd_cuda if wide
                    else bwd.lattice_bias_bwd_cuda)
            tag = "wide" if wide else "whole"
            rec[tag] = dict(bias_bwd_plan(cs, bwd, libs[wide], n_sm, wide, B,
                                          G, N, Wt, H),
                            ms=best(lambda: call(*args, gout, H, H)))
        if hasattr(cs, "grid_sample_args"):
            inp, grid, go = cs.grid_sample_args(da, table, k_pos, gout, H)
            rec["library_ms"] = best(
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    go, inp, grid, 0, 0, True, [True, True]))
            del inp, grid, go
        result["ms"][name] = rec
        print(f"bias_bwd {name} (x{per} a step): " + "; ".join(
            f"{k} " + (", ".join(f"{a} {b:.4f}" if isinstance(b, float)
                                 else f"{a} {b if b is not None else '-'}"
                                 for a, b in v.items())
                       if isinstance(v, dict) else f"{v:.4f}")
            for k, v in rec.items()) + f" [{card}]", flush=True)
        del table, k_pos, gout, args
        torch.cuda.empty_cache()


def bias_fwd_plan(cs, fwd, lib, n_sm, kernel, B, G, N, Wt, H) -> dict:
    """Path, key runs, row strips, shared memory, threads, grid blocks,
    blocks an SM holds and waves of one launch of ``kernel``
    (``lattice_bias`` #1, ``lattice_bias_wide`` #4 or
    ``lattice_bias_wide_prefetch`` #5) at a site of BEV H x H with
    chip_smoke's heads per group: ``lattice_bias.fwd_plan`` where the
    checkout has it for that kernel, else the launch of the kernel before
    the template (#1 then: a block of 256 threads a (group, batch, run of
    keys) with the group's padded tables in shared memory, path "group").
    Blocks an SM from the library's ``<kernel>_occupancy``; "-" where it
    does not export it."""
    from bevrender_tpu_torch.ops.kernels._launch import padded_width

    Hpg, Ht = cs.HPG, 2 * H - 1
    new = hasattr(fwd, "FWD_KERNELS")
    if new or kernel != "lattice_bias":
        p = fwd.fwd_plan(B, G, Hpg, Ht, Wt, N, H, H, n_sm, kernel if new
                         else kernel == "lattice_bias_wide_prefetch")
        rec = dict(path=p.path, runs=p.runs, keys=p.keys, strips=p.strips,
                   rows=p.rows, smem=p.smem,
                   threads=fwd.FWD_THREADS, blocks=p.blocks)
    else:
        kpb = max(1, min(64, -(-B * G * N // (2 * n_sm))))
        rec = dict(path="group", runs=-(-N // kpb), keys=kpb, strips=None,
                   rows=None, smem=Hpg * (Ht + 8) * padded_width(Wt) * 2,
                   threads=256, blocks=-(-N // kpb) * G * B)
    rec.update(per_sm=None, waves=None)
    occupancy = getattr(lib, f"{kernel}_occupancy", None)
    if occupancy is not None:
        whole = (int(rec["path"] == "whole"),)
        args = {"lattice_bias": whole,
                "lattice_bias_wide": (),
                "lattice_bias_wide_prefetch": whole}[kernel] + (H, rec["smem"])
        rec["per_sm"] = occupancy(*args)
        if rec["per_sm"] <= 0:
            raise SystemExit(f"occupancy query failed: {rec['per_sm']}")
        rec["waves"] = -(-rec["blocks"] // (rec["per_sm"] * n_sm))
    return rec


# (name, H, batch, G, N, table width, seed, launches a forward of #4 on its
# route, of #5 on its route): the shapes phases 12 and 18 hold the wide
# bias forwards at, with their seeds (chip_smoke.PREFETCH_BIAS_SITES, then
# the pyramid's TSA 56 of PYR_BIAS_SITES, which no route launches them at)
def bias_fwd_shapes(cs) -> list:
    shapes = [(name, H, B, G, N, Wt, 100 + i, per, per)
              for i, (name, H, B, G, N, Wt, per) in enumerate(
                  cs.PREFETCH_BIAS_SITES)]
    for i, (name, H, B, G, N, Wt) in enumerate(cs.PYR_BIAS_SITES):
        if name == "tsa56_g1_n49":
            shapes.append((f"pyramid_{name}", H, B, G, N, Wt, 70 + i, 0, 0))
    return shapes


# where #1's launches of a shape are summed: a flagship serving forward
# (B=4), a flagship training step on the default route, a pyramid serving
# forward and a pyramid training step
BIAS_SUMS = ("flagship forward", "flagship step", "pyramid forward",
             "pyramid step")


def bias_shapes(cs) -> list:
    """(name, H, batch, G, N, table width, seed, {sum: launches}) of every
    shape #1 (``lattice_bias``) takes: phase 4's (the flagship's serving
    sites), phase 8's (its training step: the final pass and its
    recomputation at every site, the history pass at the head widths over
    8, which the fused site does not take) and phase 12's (the pyramid's,
    but SCA 56, which takes #4; a step runs 1.5 forwards)."""
    shapes = [(f"serve_{name}", cs.H, B, G, N, Wt, 200 + i,
               {"flagship forward": per})
              for i, (name, B, G, ch, N, Wt, per) in enumerate(cs.BIAS_SITES)]
    shapes += [(f"train_{name}", cs.H, B, G, N, Wt, 210 + i,
                {"flagship step": per * (3 if ch > 8 else 2)})
               for i, (name, B, G, ch, N, Wt, per) in enumerate(
                   cs.TRAIN_BIAS_SITES)]
    shapes += [(f"pyramid_{name}", H, B, G, N, Wt, 220 + i,
                {"pyramid forward": cs.PYR_BIAS_PER_FORWARD[name],
                 "pyramid step": cs.PYR_BIAS_PER_FORWARD[name] * 3 // 2})
               for i, (name, H, B, G, N, Wt) in enumerate(cs.PYR_BIAS_SITES)
               if name != "sca56_g1_n7840"]
    return shapes


# a kernel of the card's launch floor (an empty block) and store floor (the
# grid writing a constant over the output, 16 bytes a thread, each block a
# contiguous share), for any grid, block and shared memory
FLOORS_CU = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

__global__ void store_kernel(uint4* __restrict__ out, long long n) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long end = min(n, (blockIdx.x + 1) * per);
  for (long long i = blockIdx.x * per + threadIdx.x; i < end; i += blockDim.x)
    out[i] = make_uint4(0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u);
}

extern "C" int floor_launch(int store, void* out, long long bytes, int blocks,
                            int threads, int smem, void* stream) {
  const void* k = store ? (const void*)store_kernel : (const void*)empty_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (store)
    store_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (uint4*)out, bytes / 16);
  else
    empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def floors_lib():
    """FLOORS_CU built with the kernels' nvcc flags under build/, loaded."""
    import ctypes
    import hashlib

    from bevrender_tpu_torch.ops.kernels import build

    h = hashlib.sha256((FLOORS_CU + " ".join(build.NVCC_FLAGS)).encode())
    out = REPO / "build" / "bias_fwd_floors" / h.hexdigest()[:16]
    lib = out / "libfloors.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / "floors.cu").write_text(FLOORS_CU)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(out / "floors.cu")], check=True,
                       capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def floor_ms(best, fn, store: bool, out, blocks, threads, smem) -> float:
    """The launch floor (an empty kernel) or the store floor of a grid of
    ``blocks`` x ``threads`` with ``smem`` bytes of shared memory, writing
    the bytes of ``out``."""
    import torch

    def launch():
        rc = fn(int(store), out.data_ptr(), out.numel() * out.element_size(),
                blocks, threads, smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"floor_launch: CUDA error {rc}")

    return best(launch)


def bias_fwd_times(cs, card: str, result: dict, floors: bool,
                   layouts: bool) -> None:
    """#1 (``lattice_bias``) at every shape it takes (``bias_shapes``) and
    #4 (``lattice_bias_wide``), #5 (``lattice_bias_wide_prefetch``; before
    it staged from the raw table, its pitched table copy included) at
    phases 12 and 18's shapes
    (``bias_fwd_shapes``), each with its plan (``bias_fwd_plan``), and
    ``F.grid_sample`` of the same inputs (``chip_smoke.grid_sample_args``:
    bilinear, zero padding, align_corners, one call for every head) as the
    library time; then each kernel summed over the launches of one forward
    (and, for #1, one training step) of its route. With ``floors``, beside
    #1 the launch floor and the store floor of its grid (``floor_ms``);
    with ``layouts``, #1 on both of its paths (``lattice_bias_cuda(...,
    path=...)``) where the checkout has them."""
    import torch

    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops.kernels import build

    fwd = __import__("bevrender_tpu_torch.ops.kernels.lattice_bias",
                     fromlist=["x"])
    names = ("lattice_bias", "lattice_bias_wide", "lattice_bias_wide_prefetch")
    libs = {k: build.load_library(k) for k in names}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    best = lambda fn: min(cs.queued_ms(fn, 5) for _ in range(3))  # noqa: E731
    floor_fn = floors_lib() if floors else None
    sums = collections.defaultdict(float)

    def show(name, rec, per):
        print(f"bias_fwd {name} (x{per}): " + "; ".join(
            f"{k} " + (", ".join(f"{a} {b:.4f}" if isinstance(b, float)
                                 else f"{a} {b if b is not None else '-'}"
                                 for a, b in v.items())
                       if isinstance(v, dict) else f"{v:.4f}")
            for k, v in rec.items()) + f" [{card}]", flush=True)

    for name, H, B, G, N, Wt, seed, per in bias_shapes(cs):
        table, k_pos, _ = cs.bias_inputs(seed, B, G, N, Wt, H,
                                         cs.SITE_TABLE_STDS[0])
        args = da._kernel_args(table, k_pos, H, H)
        plan = bias_fwd_plan(cs, fwd, libs["lattice_bias"], n_sm,
                             "lattice_bias", B, G, N, Wt, H)
        rec = {"bias": dict(plan, ms=best(
            lambda: fwd.lattice_bias_cuda(*args, H, H)))}
        if floors:
            out = fwd.lattice_bias_cuda(*args, H, H)
            grid = (plan["blocks"], plan["threads"], plan["smem"])
            rec["bias"]["launch_floor"] = floor_ms(best, floor_fn, False, out,
                                                   *grid)
            rec["bias"]["store_floor"] = floor_ms(best, floor_fn, True, out,
                                                  *grid)
        if layouts and hasattr(fwd, "fwd_layout"):
            rec["layouts"] = {}
            for path in ("l1", "whole"):
                rec["layouts"][path] = best(
                    lambda: fwd.lattice_bias_cuda(*args, H, H, path=path))
        inp, grid, _ = cs.grid_sample_args(da, table, k_pos, None, H)
        rec["library_ms"] = best(lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        for k, n in per.items():
            sums[f"bias {k}"] += n * rec["bias"]["ms"]
            sums[f"library {k}"] += n * rec["library_ms"]
        result["ms"][name] = rec
        show(name, rec, per)
        del table, k_pos, args, inp, grid
        torch.cuda.empty_cache()

    for name, H, B, G, N, Wt, seed, per4, per5 in bias_fwd_shapes(cs):
        table, k_pos, _ = cs.bias_inputs(seed, B, G, N, Wt, H,
                                         cs.SITE_TABLE_STDS[0])
        args = da._kernel_args(table, k_pos, H, H)[:7]
        rec = {}
        model = "pyramid" if H == 56 else "flagship"
        for kernel, tag, per in (("lattice_bias_wide", "wide", per4),
                                 ("lattice_bias_wide_prefetch", "prefetch",
                                  per5)):
            call = getattr(fwd, f"{kernel}_cuda")
            rec[tag] = dict(bias_fwd_plan(cs, fwd, libs[kernel], n_sm,
                                          kernel, B, G, N, Wt, H),
                            ms=best(lambda: call(*args, H, H)))
            sums[f"{tag} {model}"] += per * rec[tag]["ms"]
        inp, grid, _ = cs.grid_sample_args(da, table, k_pos, None, H)
        rec["library_ms"] = best(lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        sums[f"library {model}"] += per4 * rec["library_ms"]
        result["ms"][f"wide_{name}"] = rec
        show(f"wide_{name}", rec, per4)
        del table, k_pos, args, inp, grid
        torch.cuda.empty_cache()
    result["forward_sums"] = dict(sums)
    print("bias_fwd summed over the launches of a forward or step (#1 on its "
          "routes; #4 and #5 on the flagship's \"wide\" and the pyramid's SCA "
          "56): " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
          + f" [{card}]", flush=True)


def fwd_sass(lib: Path) -> dict:
    """Per kernel of a bias forward library: registers, its SASS
    instruction count and loop lengths (``sass_loops``), and its global and
    shared loads and stores, asynchronous copies and barriers."""
    regs = registers(lib)
    loops = sass_loops(lib)
    keep = ("LDG", "LDS", "STG", "STS", "LDGSTS", "BAR", "F2FP")
    return {name: dict(registers=regs.get(name), **loops.get(name, {}),
                       ops={k: v for k, v in sorted(ops.items())
                            if k.startswith(keep)})
            for name, ops in sass_functions(lib).items()}


# what each copy changes, (file under csrc/, text, new text): in #7's raw
# path, "wide_minb3" and "wide_minb2" ask the compiler for 3 or 2
# blocks an SM of 160 threads (room for more registers) in place of 4;
# "wide_strip" takes ``fused_site_fold.strip``'s fewest strips in place of
# ``wave_strip``'s. In the bias forwards:
# "no_staging" skips the staging of the table in shared memory (the
# stage_padded call of #1 before the template, or the template's stage_raw
# call), so the kernel reads whatever shared memory holds; "no_row_test"
# drops the test of a strip's first x-lerp (always true) that the staged
# W > 32 instance keeps, which changes how the compiler unrolls its row loop
COPIES = {
    "wide_minb3": (("fused_site_wide.cu", "constexpr int MIN_BLOCKS = 4;",
                    "constexpr int MIN_BLOCKS = 3;"),),
    "wide_minb2": (("fused_site_wide.cu", "constexpr int MIN_BLOCKS = 4;",
                    "constexpr int MIN_BLOCKS = 2;"),),
    "wide_strip": (("../fused_site_wide.py",
                    "S = wave_strip(1, H * W, heads, per_sm, sms, "
                    "WIDE_THREADS)",
                    "from bevrender_tpu_torch.ops.kernels.fused_site_fold "
                    "import strip\n    S = strip(1, H * W, WIDE_THREADS)"),),
    "no_staging": (
    ("lattice_bias.cu", "lattice::stage_padded(",
     "if (0) lattice::stage_padded("),
    ("bias_fwd_rows.cuh", "t = stage_raw(",
     "t = tab;\n    if (0) stage_raw(")),
    "no_row_test": (
    ("bias_fwd_rows.cuh",
     "if (!STAGED || P < 32 || iy0 < iy1) xlerp(y0 + iy0, up);",
     "xlerp(y0 + iy0, up);"),)}


@functools.lru_cache(maxsize=None)
def make_copy(root: Path, copy: str) -> Path:
    """A copy of ``root``'s package under the git-ignored build/ with the
    edits of COPIES[copy], for timing only; made once a run of this
    script."""
    dst = REPO / "build" / "bias_fwd_copies" / f"{root.name}_{copy}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "bevrender_tpu_torch", dst / "bevrender_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = dst / "bevrender_tpu_torch" / "ops" / "kernels" / "csrc"
    edited = 0
    for name, old, new in COPIES[copy]:
        text = (csrc / name).read_text()
        if old in text:
            (csrc / name).write_text(text.replace(old, new))
            edited += text.count(old)
    if edited != 1:
        raise SystemExit(f"{copy}: {edited} calls edited in {root}, not 1")
    return dst


def run_in_turns(specs: list, argv: list) -> None:
    """Run this script once for each of ``specs`` (ROOT or ROOT:COPY), in
    that order, each in its own process, then print for each shape and
    kernel the least time of each spec's runs, and the most of them (the
    spread between runs): parent, tree, tree, parent compares two builds on
    one card."""
    runs = []
    for spec in specs:
        root, _, copy = spec.partition(":")
        root = Path(root).resolve()
        if copy:
            root = make_copy(root, copy)
        out = subprocess.run([sys.executable, __file__, *argv, "--root",
                              str(root)], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise SystemExit(f"{spec}: exit {out.returncode}")
        runs.append((spec, json.loads(out.stdout.strip().splitlines()[-1])))
    best = collections.defaultdict(dict)
    most = collections.defaultdict(dict)
    for spec, res in runs:
        for shape, rec in res["ms"].items():
            for kernel, v in rec.items():
                if not isinstance(v, (float, dict)):
                    continue  # a plan's name or count
                vals = v if kernel == "layouts" else {"ms": v} if isinstance(
                    v, float) else {k: x for k, x in v.items()
                                    if k in ("ms", "launch_floor",
                                             "store_floor")}
                for k, x in vals.items():
                    key = (shape, kernel, k)
                    best[spec][key] = min(x, best[spec].get(key, x))
                    most[spec][key] = max(x, most[spec].get(key, x))
        for k, x in res.get("forward_sums", {}).items():
            key = ("sum", k, "ms")
            best[spec][key] = min(x, best[spec].get(key, x))
            most[spec][key] = max(x, most[spec].get(key, x))
    summary = {spec: {" ".join(k): v for k, v in b.items()}
               for spec, b in best.items()}
    spread = {spec: {" ".join(k): v for k, v in b.items()}
              for spec, b in most.items()}
    for spec, b in summary.items():
        print(f"least (most) of {spec}: " + "; ".join(
            f"{k} {v:.4f} ({spread[spec][k]:.4f})" for k, v in b.items()),
            flush=True)
    print(json.dumps({"card": runs[0][1]["card"], "order": specs,
                      "least": summary, "most": spread}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel",
                    choices=("site_bwd", "windows_bwd", "fold_heads",
                             "prefetch", "bias_bwd", "bias_fwd"),
                    default="site_bwd")
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--floors", action="store_true",
                    help="bias_fwd: #1's launch and store floors")
    ap.add_argument("--layouts", action="store_true",
                    help="bias_fwd: #1 on both of its paths")
    ap.add_argument("--runs", default="",
                    help="comma-separated ROOT or ROOT:COPY (COPIES), run "
                         "in this order, each in its own process")
    args = ap.parse_args()
    if args.runs:
        argv = ["--kernel", args.kernel] + [
            f"--{f}" for f in ("sass", "floors", "layouts")
            if getattr(args, f)]
        run_in_turns(args.runs.split(","), argv)
        return
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"bevrender_tpu_torch not taken from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; root: {root}; kernel: {args.kernel}", flush=True)
    sources = dict(site_bwd=("fused_site_bwd",),
                   windows_bwd=("lattice_windows",),
                   fold_heads=("fused_site_fold_heads",),
                   prefetch=("fused_site_wide_prefetch", "fused_site_wide",
                             "fused_site_fold_rows", "fused_site_fold_heads",
                             "fused_site"),
                   bias_bwd=("lattice_bias_bwd", "lattice_bias_wide_bwd"),
                   bias_fwd=("lattice_bias", "lattice_bias_wide",
                             "lattice_bias_wide_prefetch"),
                   )[args.kernel]
    started = {s: build._start(s) for s in sources}
    logs = {s: build._finish(s, *started[s]) for s in sources}
    lib = started[sources[0]][1]
    log = "\n".join(logs.values())
    result = {"card": card, "root": str(root), "kernel": args.kernel,
              "ms": {}}
    if args.sass:
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"ptxas: {ln.strip()}", flush=True)
        if args.kernel == "bias_fwd":
            result["sass"] = {}
            for s in sources:
                result["sass"].update(fwd_sass(started[s][1]))
            for name, rec in result["sass"].items():
                print(f"sass {name}: {rec}", flush=True)
        elif args.kernel == "site_bwd":
            result["sass_ch8"] = sass_counts(lib)
            print(f"sass (ch 8): {result['sass_ch8']}", flush=True)
        elif args.kernel in ("fold_heads", "prefetch", "bias_bwd"):
            result["registers"], result["sass"] = {}, {}
            for s in sources:
                result["registers"].update(registers(started[s][1]))
                result["sass"].update(fold_sass(started[s][1]))
            if args.kernel == "bias_bwd":
                result["loops"] = {}
                for s in sources:
                    result["loops"].update(sass_loops(started[s][1]))
            for name, ops in result["sass"].items():
                print(f"sass {name}: registers "
                      f"{result['registers'].get(name, '-')}, {ops}"
                      + (f", {result['loops'][name]}"
                         if name in result.get("loops", {}) else ""),
                      flush=True)
        else:
            result["sass"] = windows_sass(lib)
            for name, rec in result["sass"].items():
                print(f"sass {name}: {rec}", flush=True)
    {"site_bwd": site_bwd_times, "windows_bwd": windows_bwd_times,
     "fold_heads": fold_heads_times, "prefetch": prefetch_times,
     "bias_bwd": bias_bwd_times,
     "bias_fwd": functools.partial(bias_fwd_times, floors=args.floors,
                                   layouts=args.layouts)
     }[args.kernel](cs, card, result)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

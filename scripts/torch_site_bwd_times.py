"""Time the port's fused site backward kernel (csrc/fused_site_bwd.cu)
through its wrapper at the four shapes a flagship training step gives it
(``chip_smoke.TRAIN_SITE_SITES``), on one CUDA card.

    python3 scripts/torch_site_bwd_times.py [--root DIR] [--sass]

``--root`` names the checkout whose ``bevrender_tpu_torch`` is built and
timed (default: this one): for example an older commit unpacked with
``git archive`` into a git-ignored directory, or a copy of the tree with
the kernel's source edited. To compare two builds, run the script once for
each back to back on one card, in the order A, B, B, A. The inputs are
``chip_smoke.site_inputs`` with fixed seeds, the same for every root; each
time is the least of three ``chip_smoke.queued_ms`` readings of five
wrapper calls (the zero-fills of its outputs included). ``--sass`` also
prints the build's ``ptxas`` register report and, in the SASS of its
``ch = 8`` kernel, the count of each shared-memory atomic, shuffle and mma
opcode. The last line is one JSON object with the card and the times.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# one SASS line's opcode, after its address and any predicate
SASS_OP = r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"


def sass_counts(lib: Path) -> dict:
    """Opcode counts of interest in the ch = 8 instance of the kernel."""
    from bevrender_tpu_torch.ops.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", out)
    body = next(f for f in funcs if "site_bwd_kernel" in f.split("\n")[0]
                and "ILi8E" in f.split("\n")[0])
    ops = collections.Counter(m.group(1) for m in
                              map(lambda ln: re.match(SASS_OP, ln),
                                  body.splitlines()) if m)
    keep = ("ATOMS", "ATOM.", "RED", "SHFL", "HMMA", "MOVM")
    return {k: v for k, v in sorted(ops.items()) if k.startswith(keep)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bevrender_tpu_torch.ops import deform_attn as da
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"bevrender_tpu_torch not taken from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; root: {root}", flush=True)
    proc, lib, tmp = build._start("fused_site_bwd")
    log = build._finish("fused_site_bwd", proc, lib, tmp)
    result = {"card": card, "root": str(root), "ms": {}}
    if args.sass:
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"ptxas: {ln.strip()}", flush=True)
        result["sass_ch8"] = sass_counts(lib)
        print(f"sass (ch 8): {result['sass_ch8']}", flush=True)

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
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

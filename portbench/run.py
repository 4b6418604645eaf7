"""Benchmark of the PyTorch and CUDA port (``bevrender_tpu_torch``): one run
of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``check``, the numbers that
decided ``correct`` beside their limits (also the last lines of standard
error). Exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell's chips) and when JAX, flax or the JAX package is
loaded once the window has closed. A cell on several chips starts one
process a chip (NCCL over ``tcp://127.0.0.1``); rank 0 prints the line.

Build and kernel caches stay inside the checkout (``build/``).
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 1500


def _environment() -> None:
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    # the plain path on the CPU over gloo: a rehearsal of the launcher and
    # the harness, never a measurement
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def context(cell: str, seed: int, seconds: float, trace: int, device,
            rank: int = 0, world: int = 1, t0: float = T0,
            root: str = ROOT) -> dict:
    from portbench.harness.cell import resolve

    ctx = resolve(root, cell)
    ctx.update(root=root, seed=seed, seconds=seconds, trace=bool(trace),
               device=device, rank=rank, world=world, t0=t0)
    return ctx


def driver(ctx: dict):
    from portbench.harness import register, train

    return {"train": train, "register": register}[ctx["traffic"]["kind"]]


def device_info(dev, world: int, peak: int) -> dict:
    import torch

    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
            "count": world, "memory_peak_bytes": peak}


def run_rank(ctx: dict, out=sys.stdout) -> int:
    """Run the cell in this process (one rank); rank 0 prints the line."""
    import torch

    from portbench.harness import check
    from portbench.harness.cell import banned_modules, dumps, result_line
    from portbench.harness.trace import busy_us, span_us

    dev, rank, world = ctx["device"], ctx["rank"], ctx["world"]
    mod = driver(ctx)
    rec = mod.run(ctx)
    busy = (busy_us(rec["trace"]) * 1e-6, span_us(rec["trace"]) * 1e-6) \
        if rec.get("trace") else None
    if world > 1:
        mine = [rec["peak"], busy]
        everyone = [None] * world
        torch.distributed.all_gather_object(everyone, mine)
        if rank != 0:
            torch.distributed.destroy_process_group()
            return 0
        rec["peak"] = max(e[0] for e in everyone)
        if busy is not None:
            busy = (sum(e[1][0] for e in everyone) / world,
                    sum(e[1][1] for e in everyone) / world)
    numbers = mod.numbers(ctx, rec["check_inputs"])
    if world > 1:
        torch.distributed.destroy_process_group()
    found = banned_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    ok, check_out = check.judge(numbers,
                                check.load_limits(ctx["root"], ctx["cell"]))
    device = device_info(dev, world, rec["peak"])
    if busy is not None:
        device["busy_s"], device["window_s"] = busy
    print(dumps(result_line(ctx, rec, ok, check_out, device)), file=out,
          flush=True)
    return 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world: int) -> int:
    """One process a chip; rank 0's output printed last, after the
    others' standard error."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="portbench_ranks_") as logs:
        procs, files = [], []
        for r in range(world):
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(r), "--port", str(port), "--t0", repr(T0),
                   "--device", args.device]
            fo = open(os.path.join(logs, f"{r}.out"), "w")
            fe = open(os.path.join(logs, f"{r}.err"), "w")
            files.append((fo, fe))
            procs.append(subprocess.Popen(
                cmd, stdout=fo, stderr=fe,
                env=dict(os.environ, LOCAL_RANK=str(r))))
        deadline = time.time() + RANK_TIMEOUT_S
        rcs = [None] * world
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs) or time.time() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for i, p in enumerate(procs):
                    rcs[i] = p.wait()
                break
            time.sleep(0.2)
        for fo, fe in files:
            fo.close()
            fe.close()
        for r in list(range(1, world)) + [0]:
            with open(os.path.join(logs, f"{r}.err")) as f:
                sys.stderr.write(f.read())
        sys.stderr.flush()
        bad = [rc for rc in rcs if rc != 0]
        if not bad:
            with open(os.path.join(logs, "0.out")) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
        return bad[0] if bad else 0


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    from portbench.harness.cell import resolve

    world = resolve(ROOT, args.workload)["work"]["chips"]
    import torch

    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < world):
        print(f"needs {world} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if world > 1 and args.rank is None:
        return launch(args, world)
    rank = args.rank or 0
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    if world > 1:
        from bevrender_tpu_torch.parallel import dist as pdist

        pdist.initialize_distributed(
            dev, init_method=f"tcp://127.0.0.1:{args.port}", rank=rank,
            world_size=world)
    ctx = context(args.workload, args.seed, args.seconds, args.trace, dev,
                  rank, world, args.t0 if args.t0 is not None else T0)
    return run_rank(ctx)


if __name__ == "__main__":
    sys.exit(main())

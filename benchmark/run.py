"""The benchmark's one command:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  It runs the cell on the card it is started
on and prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), `device`, `checks`
(each number the check compared, with its limit) and, with --trace 1,
`breakdown`.  The numbers compared are also the last lines of its standard
error.  Without a card, or with fewer than the cell asks for, it prints no
result and exits with 2; if the JAX package or JAX is loaded once the
window has closed, it names them and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One compute thread for the host work of torch and of the BLAS libraries,
# as subread-align's -T 1: their idle workers spin on the cores that the
# Python thread which parses FASTQ and writes BAM needs, and move its speed
# from run to run.  Set before torch or numpy is loaded.
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "subread_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The modules of names (default: those loaded) whose top-level name,
    the part before the first dot, is one of FORBIDDEN as a whole name."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"(nvidia-smi: {e})"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control of `correct` (PERF.md): the cell with -M raised to the
    # limits file's control_max_mismatches; never part of a benchmark run
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from .spec import HERE, Spec

    spec = Spec()
    cell = spec.workload(args.workload)
    cache = HERE / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from .harness import run_cell

    r = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                 T_START, control=args.control,
                 log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"], memory_peak_bytes=r["memory_peak_bytes"])
    if args.trace:
        device.update(busy_s=r["busy_s"], window_s=r["window_s"])
        print("bench: card " + power_limit(), file=sys.stderr)
    line = dict(correct=r["correct"], attempted=r["attempted"],
                failed=r["failed"], metrics=r["metrics"], device=device)
    if args.trace:
        line["breakdown"] = r["breakdown"]
    line["checks"] = r["checks"]
    for k, (v, lim) in r["checks"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

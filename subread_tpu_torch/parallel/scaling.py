"""Scaling harnesses for the sharded align step: two modes, two metrics.

Port of `subread_tpu/parallel/scaling.py` onto torch devices.  The
reference scales by adding pthreads over shared memory (core.c:3379-3461);
here the unit of scaling is a mesh device.
`python -m subread_tpu_torch.parallel.scaling` runs either:

* ``measure_weak_scaling``: per-device read load held constant, mesh
  grown; efficiency(N) = t(1)/t(N).
* ``measure_sharding_overhead``: constant total work, the same batch on
  1 device and sharded over N; overhead(N) = t(N)/t(1) isolates what the
  split, gathers and fold add, and its inverse approximates the
  efficiency on hardware where each device brings its own compute.

Both check that every sharded step equals `_device_align` on the whole
batch on one device (`bit_equal`); `main` exits 1 when one does not.

The devices are explicit: by default the visible cards, and a mesh over
more cards than are visible raises (`mesh.make_mesh`); nothing falls back
to the CPU.  `--devices-list cpu,cpu` names them outright (a device may
repeat, which times the split and gathers on one device).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _setup(per_device_reads: int, n_devices: int, device, read_len: int = 100,
           seed: int = 3):
    """An aligner on `device` over a 200 kb synthetic genome and
    per_device_reads * n_devices simulated reads, as host arrays."""
    from ..align.pipeline import Aligner
    from ..config import aligner_config
    from ..index.build import build_hash_index
    from ..synth import synthetic_genome, synthetic_reads

    genome = synthetic_genome(200_000, seed=seed, n_contigs=1)
    index = build_hash_index(genome, index_gap=1)
    n_reads = per_device_reads * n_devices
    cfg = aligner_config(batch_reads=n_reads, pad_read_len=read_len)
    aligner = Aligner(genome, index, cfg, device=device)
    b = synthetic_reads(genome, n_reads, seed=seed + 1, read_len=read_len)
    return (aligner, np.ascontiguousarray(b.codes[:, :read_len]),
            np.ascontiguousarray(b.ambig[:, :read_len]),
            b.lengths.astype(np.int32))


def _sync(mesh) -> None:
    for d in mesh.distinct():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _equal_to_one_device(step, aligner, args) -> bool:
    """Whether the sharded step's result equals `_device_align` on the
    whole batch on the aligner's own device, key by key."""
    got = step(*args)
    want = aligner._device_align(*aligner._upload_reads(*args))
    return sorted(got) == sorted(want) and all(
        torch.equal(got[k].to(want[k].device), want[k]) for k in want)


def _best(step, mesh, args, reps: int) -> float:
    step(*args)        # warm-up: allocator, kernel build
    _sync(mesh)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        step(*args)
        _sync(mesh)
        best = min(best, time.perf_counter() - t0)
    return best


def _devices(devices, n_max: int):
    from .mesh import mesh_devices, visible_cards

    devs = visible_cards(n_max) if devices is None else mesh_devices(devices)
    if len(devs) < n_max:
        raise RuntimeError(f"{n_max} devices asked for; {len(devs)} given")
    return devs


def measure_weak_scaling(device_counts=(1, 2, 8), per_device_reads=2048,
                         reps: int = 5, devices=None) -> dict:
    """Time the full sharded align step at each mesh size; returns
    {n: {"step_s": best, "reads_per_s": ..., "efficiency": ...,
    "bit_equal": the step's result equals one device's}}."""
    from .mesh import make_mesh, sharded_align_step

    devices = _devices(devices, max(device_counts))
    results: dict[int, dict] = {}
    t1 = None
    for n in device_counts:
        mesh = make_mesh(devices=devices[:n])
        aligner, codes, ambig, lens = _setup(per_device_reads, n, devices[0])
        step = sharded_align_step(mesh, aligner)
        best = _best(step, mesh, (codes, ambig, lens), reps)
        if t1 is None:
            t1 = best
        results[n] = {
            "reads": len(lens),
            "step_s": best,
            "reads_per_s": len(lens) / best,
            "efficiency": t1 / best,
            "bit_equal": _equal_to_one_device(step, aligner, (codes, ambig, lens)),
        }
    return results


def measure_sharding_overhead(device_counts=(1, 2, 8), total_reads=16384,
                              reps: int = 3, devices=None) -> dict:
    """Constant-total-work sharding overhead: time the same `total_reads`
    batch on 1 device and sharded over N.  With the total work held
    constant, overhead(N) = t(N devices) / t(1 device) isolates what
    sharding adds: the per-part launches, the gathers onto the first
    device and the tiers' global compaction.  Its inverse is the
    projected weak-scaling efficiency where every device brings its own
    compute."""
    from .mesh import make_mesh, sharded_align_step

    devices = _devices(devices, max(device_counts))
    results: dict[int, dict] = {}
    t1 = None
    aligner, codes, ambig, lens = _setup(total_reads, 1, devices[0])
    for n in device_counts:
        mesh = make_mesh(devices=devices[:n])
        step = sharded_align_step(mesh, aligner)
        best = _best(step, mesh, (codes, ambig, lens), reps)
        if t1 is None:
            t1 = best
        results[n] = {
            "reads": total_reads,
            "step_s": best,
            "overhead": best / t1,
            "projected_efficiency": t1 / best,
            "bit_equal": _equal_to_one_device(step, aligner, (codes, ambig, lens)),
        }
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", default="1,2,8", help="mesh sizes")
    ap.add_argument("--devices-list", default=None,
                    help="comma-separated torch devices (default: the cards)")
    ap.add_argument("--reads", type=int, default=2048,
                    help="reads per device per step")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--total-work", action="store_true",
                    help="constant-total-work sharding-overhead mode")
    args = ap.parse_args(argv)
    counts = tuple(int(x) for x in args.devices.split(","))
    devices = args.devices_list.split(",") if args.devices_list else None
    if args.total_work:
        res = measure_sharding_overhead(counts, args.reads, args.reps, devices)
        for n, r in res.items():
            print(
                f"devices={n:2d}  step={r['step_s'] * 1e3:8.1f} ms  "
                f"overhead={r['overhead']:.3f}  "
                f"projected_efficiency={r['projected_efficiency']:.3f}  "
                f"bit_equal={r['bit_equal']}"
            )
        print(json.dumps({
            "metric": "sharding_overhead_projected_efficiency",
            "value": res[counts[-1]]["projected_efficiency"],
            "unit": f"t(1)/t({counts[-1]}) at {args.reads} total reads",
            "per_n": {str(n): r["projected_efficiency"]
                      for n, r in res.items()},
            "bit_equal": all(r["bit_equal"] for r in res.values()),
        }))
        return 0 if all(r["bit_equal"] for r in res.values()) else 1
    res = measure_weak_scaling(counts, args.reads, args.reps, devices)
    for n, r in res.items():
        print(
            f"devices={n:2d}  reads/step={r['reads']:6d}  "
            f"step={r['step_s'] * 1e3:8.1f} ms  "
            f"reads/s={r['reads_per_s']:10.0f}  "
            f"efficiency={r['efficiency']:.2f}  bit_equal={r['bit_equal']}"
        )
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": res[counts[-1]]["efficiency"],
        "unit": f"t(1)/t({counts[-1]}) at {args.reads} reads/device",
        "per_n": {str(n): r["efficiency"] for n, r in res.items()},
        "bit_equal": all(r["bit_equal"] for r in res.values()),
    }))
    return 0 if all(r["bit_equal"] for r in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-process orchestration over torch.distributed.

Port of `subread_tpu/parallel/distributed.py`, which connects hosts with
`jax.distributed`.  Here `init_distributed` starts a torch.distributed
process group: NCCL for a card, gloo between CPU processes.  Each process
streams its own shard of the reads (`host_shard_range`) and feeds its own
cards; the small result statistics and event tables ride collectives
(`psum_stats`, `allgather_event_table`).  Ordered output: each process
writes `<out>.part-<rank>` and rank 0 concatenates (`merge_output_parts`,
the analog of the reference's output_lock ordering, core.c:2383).

Everything here also runs in one process with no group (the common case):
`init_distributed()` does nothing when no coordinator is configured, and
the collectives then return their local input.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import make_mesh


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Start the process group.  The coordinator (`host:port` or
    `tcp://host:port`) comes from the argument or from
    SUBREAD_TPU_COORDINATOR, as in the JAX package: it is a deployment
    address, read from the environment so a launcher can hand it to every
    process; it changes no result.  With no coordinator this does nothing
    and returns False.  Otherwise the world size and this process's rank
    must be given (torch.distributed learns of no cluster by itself);
    the backend is NCCL when `device` is a card (this process's card is
    made current and the communicator built at once, so a failing NCCL
    init raises here) and gloo for the CPU.  Returns True once the group
    is up, whatever its size."""
    coordinator = coordinator or os.environ.get("SUBREAD_TPU_COORDINATOR")
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id")
    dev = resolve_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = dict(init_method=url, world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return True


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def _comm_device() -> torch.device:
    """Where this process's collective tensors live: its card under NCCL,
    else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_shard_range(total: int, process_id: int, n_processes: int) -> range:
    """Contiguous read-index range this host owns (host-sharded input;
    the per-host analog of threads pulling chunks under input_lock,
    core.c:3379)."""
    per = -(-total // n_processes)
    start = process_id * per
    return range(start, min(start + per, total))


def global_reads_mesh():
    """1-D "reads" mesh over this process's visible cards.  torch has no
    device mesh across processes: each process drives its own cards, and
    what crosses processes goes through the collectives here."""
    return make_mesh()


def psum_stats(stats: dict[str, int]):
    """All-reduce small host statistics across processes (mapped/unique/…
    counter merge — finalise_indel_and_junction_thread analog,
    core-indel.c:1012): one all_reduce of an int64 tensor.  Works without a
    process group too."""
    if not _active():
        return dict(stats)
    keys = sorted(stats)
    t = torch.tensor([stats[k] for k in keys], dtype=torch.int64,
                     device=_comm_device())
    dist.all_reduce(t)
    return {k: int(v) for k, v in zip(keys, t.cpu().tolist())}


def _allgather(a: np.ndarray, dev) -> np.ndarray:
    """Every process's equal-length int64 array, concatenated in rank
    order."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.cat(out).cpu().numpy()


def allgather_event_table(
    lefts: np.ndarray, rights: np.ndarray, supports: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-process junction/indel event tables between scan 1 and
    scan 2 (the cross-host analog of the per-thread event-table merge).
    Events with equal (left, right) have their supports summed."""
    if _active():
        # variable-length per process: gather the lengths, pad each table
        # to the longest, gather, and drop the padding by its zero support
        dev = _comm_device()
        m = int(_allgather(np.asarray([len(lefts)]), dev).max())
        pad = lambda a: np.pad(np.asarray(a, np.int64), (0, m - len(a)))
        dts = (lefts.dtype, rights.dtype, supports.dtype)
        lefts, rights, supports = (_allgather(pad(a), dev).astype(dt)
                                   for a, dt in zip((lefts, rights, supports), dts))
        keep = supports > 0
        lefts, rights, supports = lefts[keep], rights[keep], supports[keep]
    # dedup-sum on (left, right)
    if len(lefts) == 0:
        return lefts, rights, supports
    order = np.lexsort((rights, lefts))
    l, r, s = lefts[order], rights[order], supports[order]
    new = np.concatenate(([True], (l[1:] != l[:-1]) | (r[1:] != r[:-1])))
    gid = np.cumsum(new) - 1
    out_l = l[new]
    out_r = r[new]
    out_s = np.bincount(gid, weights=s).astype(supports.dtype)
    return out_l, out_r, out_s


def merge_output_parts(out_path: str, n_processes: int) -> None:
    """Rank-0 concatenation of per-host output parts in process order
    (ordered gather of per-chip records, SURVEY §2)."""
    with open(out_path, "wb") as out:
        for p in range(n_processes):
            part = f"{out_path}.part-{p}"
            with open(part, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
            os.remove(part)

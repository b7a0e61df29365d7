"""What a traced window's profiler saw on the card: the busy time as the
union of device intervals, the kernels by name, and the idle gaps labelled
by the benchmark's host span that covered them.

Times are the profiler's, on the wall clock (`time.time_ns`) that the host
spans use too.
"""

from __future__ import annotations

import numpy as np


def device_events(prof) -> list[tuple[str, int, int, bool]]:
    """(name, start ns, end ns, is a kernel) of every operation the profiler
    saw run on a card, from its Kineto results.  Every device operation
    that is not a copy or a fill is a kernel: the card's torch (2.11) gives
    a Kineto event no activity type."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        s = int(e.start_ns())
        name = e.name()
        out.append((name, s, s + int(e.duration_ns()),
                    not name.startswith(("Memcpy", "Memset"))))
    return out


def union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted [start, end] rows of intervals iv [n, 2]."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate(([True], iv[1:, 0] > ends[:-1]))
    starts = iv[new, 0]
    last = np.concatenate((np.flatnonzero(new)[1:] - 1, [len(iv) - 1]))
    return np.stack([starts, ends[last]], axis=1)


def summarise(events, t0_ns: int, t1_ns: int, spans, kernel: str) -> dict:
    """busy_s (the union of device intervals inside [t0, t1]), kernels (the
    kernels launched inside it), the named kernel's device seconds and
    launches (kernels whose name holds `kernel`), device_ops (the 10
    kernels with the most device time) and idle_gaps (device idle seconds by the innermost host span covering each
    gap's middle, the 10 largest)."""
    inside = [e for e in events if e[2] > t0_ns and e[1] < t1_ns]
    iv = np.asarray([(max(s, t0_ns), min(e, t1_ns)) for _, s, e, _ in inside],
                    np.int64).reshape(-1, 2)
    busy = union(iv)
    by_name: dict = {}
    for name, s, e, is_kernel in inside:
        if is_kernel:
            by_name[name] = by_name.get(name, 0) + (e - s)
    probe = [(e - s) for name, s, e, k in inside if k and kernel in name]
    edges = np.concatenate(([t0_ns], busy.reshape(-1), [t1_ns])).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    order = np.argsort(mid)
    labels = ["host.other"] + sorted({lab for lab, _, _ in spans})
    which = np.zeros(len(gaps), np.int64)
    # longest spans first, so the innermost span covering a gap labels it
    for lab, a, b in sorted(spans, key=lambda x: x[1] - x[2]):
        lo, hi = np.searchsorted(mid[order], [a, b], side="left")
        which[order[lo:hi]] = labels.index(lab)
    idle = {lab: int((gaps[which == j, 1] - gaps[which == j, 0]).sum())
            for j, lab in enumerate(labels) if (which == j).any()}
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return dict(
        busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
        kernels=sum(1 for *_, k in inside if k),
        probe_s=sum(probe) / 1e9, probe_launches=len(probe),
        device_ops=[[n[:160], s / 1e9] for n, s in top],
        idle_gaps=[[n, s / 1e9] for n, s in
                   sorted(idle.items(), key=lambda x: -x[1])[:10]],
    )

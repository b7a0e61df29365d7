"""The port's torch.distributed layer (`parallel.distributed`) between two
CPU processes over gloo, as tests/test_distributed.py runs the JAX
package's between two jax.distributed processes: `psum_stats`,
`allgather_event_table` with tables of different lengths, the rank-0
merge of ordered output parts, and the two halves of a fragment table
counted by `DeviceCounter` in each process and summed by an all_reduce,
which must equal the JAX package's single-process `count`.  The workers
import nothing of JAX or of the JAX package.  Then the same helpers in one
process with no group, against the JAX package's.

Every output is an integer or a file: the tolerance is 0."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.io.gtf import load_annotation as jload
from subread_tpu.parallel import distributed as JD
from subread_tpu.quant import device_count as jdc
from subread_tpu_torch.parallel import distributed as D
from test_torch_device_count import write_gtf, write_sam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["subread_tpu"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from subread_tpu_torch.parallel import distributed as D

coord, pid, outdir, gtf, sam = sys.argv[1:6]
pid = int(pid)
assert D.init_distributed(coord, num_processes=2, process_id=pid, device="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2

# 1. psum_stats: distinct per-process counters -> global sums everywhere
stats = D.psum_stats({"mapped": 10 + pid, "unique": 5 * (pid + 1)})

# 2. allgather_event_table: different lengths, one shared event
if pid == 0:
    lefts = np.array([100, 200, 300], np.int64)
    rights = np.array([150, 250, 350], np.int64)
    sups = np.array([3, 1, 2], np.int64)
else:
    lefts = np.array([200, 400], np.int64)
    rights = np.array([250, 450], np.int64)
    sups = np.array([4, 7], np.int64)
l, r, s = D.allgather_event_table(lefts, rights, sups)

# 3. ordered output parts + rank-0 merge
out = f"{outdir}/merged.out"
with open(f"{out}.part-{pid}", "w") as f:
    f.write(f"host{pid} line\n")
dist.barrier()
if pid == 0:
    D.merge_output_parts(out, 2)

# 4. each process counts its half of the fragment table; all_reduce sums
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.quant.device_count import DeviceCounter
dc = DeviceCounter(load_annotation(gtf), strand=0, max_sections=20, device="cpu")
ss, se, gate, stbl = dc.fragments_from_sam(sam)
F = len(gate)
lo, hi = (0, F // 2) if pid == 0 else (F // 2, F)
c, summ, _, ov = dc.count(ss[lo:hi], se[lo:hi], gate[lo:hi], stbl[lo:hi])
merged = torch.from_numpy(np.concatenate([c, summ]).astype(np.int64))
dist.all_reduce(merged)
dist.barrier()
dist.destroy_process_group()
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m in ("jax", "subread_tpu") or m.startswith(("jax.", "subread_tpu.")))]
json.dump(dict(stats=stats, events=[l.tolist(), r.tolist(), s.tolist()],
               counts=merged.tolist(), local=c.tolist(), overflow=ov, loaded=loaded),
          open(f"{outdir}/result-{pid}.json", "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo(tmp_path):
    rng = np.random.default_rng(23)
    gtf = write_gtf(tmp_path / "g.gtf", rng)
    sam = write_sam(tmp_path / "pe.sam", rng, n=1200, paired=True)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(tmp_path), gtf, sam],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    res = [json.load(open(tmp_path / f"result-{pid}.json")) for pid in range(2)]
    for r in res:
        assert r["loaded"] == []
        assert r["stats"] == {"mapped": 21, "unique": 15}
        l, rr, s = r["events"]
        assert dict(zip(zip(l, rr), s)) == {
            (100, 150): 3, (200, 250): 5, (300, 350): 2, (400, 450): 7,
        }
        assert r["overflow"] == 0
    assert (tmp_path / "merged.out").read_text() == "host0 line\nhost1 line\n"
    assert res[0]["counts"] == res[1]["counts"]
    assert res[0]["local"] != res[1]["local"]

    # the summed halves equal the JAX package's count of the whole table
    jd = jdc.DeviceCounter(jload(gtf), strand=0, max_sections=20)
    secs = jd.fragments_from_sam(sam)
    with jax.default_device(jax.devices("cpu")[0]):
        c, summ, _, ov = jd.count(*secs)
    assert res[0]["counts"] == [int(x) for x in np.concatenate([c, summ])]
    assert sum(res[0]["counts"][len(c):]) == len(secs[2])


def test_helpers_without_a_group_equal_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("SUBREAD_TPU_COORDINATOR", raising=False)
    assert D.init_distributed() is False
    for total, n in ((100, 3), (7, 4), (0, 2)):
        for p in range(n):
            assert D.host_shard_range(total, p, n) == JD.host_shard_range(total, p, n)
    stats = {"mapped": 5, "total": 10}
    assert D.psum_stats(stats) == JD.psum_stats(stats) == stats
    rng = np.random.default_rng(3)
    for dt in (np.uint32, np.int64):
        lefts = rng.integers(0, 20, 200).astype(dt)
        rights = (lefts + rng.integers(1, 4, 200)).astype(dt)
        sups = rng.integers(1, 9, 200).astype(np.int64)
        got, want = D.allgather_event_table(lefts, rights, sups), \
            JD.allgather_event_table(lefts, rights, sups)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for side, mod in (("t", D), ("j", JD)):
        for p in range(3):
            (tmp_path / f"{side}.out.part-{p}").write_bytes(bytes([p]) * (1 << 20 | p))
        mod.merge_output_parts(str(tmp_path / f"{side}.out"), 3)
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    assert sorted(f.name for f in tmp_path.iterdir()) == ["j.out", "t.out"]


def test_init_on_an_absent_card_raises(monkeypatch):
    """A coordinator with device "cuda" and no card ends with an error: no
    gloo or CPU group stands in."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("SUBREAD_TPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        D.init_distributed(num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="num_processes"):
        D.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()

"""The port's multi-device layer against its own single-device paths and
against the JAX package's mesh paths, on a mesh that names the CPU four
times (`["cpu"] * 4`; the JAX side runs on 4 of tier-1's 8 virtual CPU
devices):

  * `sharded_align_step` equals the port's `_device_align` on the whole
    batch and JAX's `_device_align` and `sharded_align_step`, on every key
    of the result dict; once on an ordinary batch, once on a batch with
    more saturated reads than the rescue tiers hold, where the per-part
    folds of naive data parallelism would differ on the device (and agree
    again after the host's saturation pass);
  * `index_sharded_vote` on a 2 x 2 mesh equals the port's block fold on
    one device and JAX's `index_sharded_vote` on a 2 x 2 mesh, on every
    field of `VoteResult`;
  * `DeviceCounter.count_sharded` equals `count` and JAX's `count_sharded`,
    single-end and paired, with records that do not divide by the mesh;
    featureCounts' mesh branch writes the single-device files;
  * `map_long_reads_sharded` equals `map_long_reads` and JAX's
    `map_long_reads_sharded`;
  * a mesh over more cards than are visible raises.

Every output is an integer: the tolerance is 0."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from subread_tpu.align import longread as jlong
from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu.ops import vote as jvote
from subread_tpu.parallel import index_shard as jshard
from subread_tpu.parallel import mesh as jmesh
from subread_tpu.quant import device_count as jdc
from subread_tpu.io.gtf import load_annotation as jload
from subread_tpu_torch.align import longread as tlong
from subread_tpu_torch.align.pipeline import Aligner, _host, _host_part, _merge_parts
from subread_tpu_torch.config import aligner_config
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.ops.vote import VoteParams, merge_vote_results, vote_batch
from subread_tpu_torch.parallel import index_shard as tshard
from subread_tpu_torch.parallel.mesh import make_mesh, sharded_align_step
from subread_tpu_torch.quant import device_count as tdc
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_long_reads, synthetic_reads,
)
from subread_tpu_torch.tools import featurecounts as tcli
from test_torch_device_count import write_gtf, write_sam

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def jax_cpus():
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices (xla_force_host_platform_device_count)")
    return devs


@pytest.fixture(scope="module")
def genomes():
    """An ordinary genome, and one half tandem arrays so that most reads
    saturate the 16-wide probe window."""
    out = {}
    for name, frac in (("plain", 0.05), ("tandem", 0.5)):
        g = synthetic_genome(300_000, seed=5, tandem_frac=frac)
        out[name] = (g, build_hash_index(g, index_gap=1))
    return out


CASES = {"plain": ("plain", 1024), "saturated-past-tiers": ("tandem", 2048)}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_align_step_equals_single_device_and_jax(genomes, jax_cpus, case):
    name, n = CASES[case]
    g, idx = genomes[name]
    cfg = aligner_config(batch_reads=256, pad_read_len=128)
    al = Aligner(g, idx, cfg, device="cpu")
    codes, ambig, lens, _ = al._pad_batch(synthetic_reads(g, n, seed=6))
    dc, da, dl = al._upload_reads(codes, ambig, lens)
    single = al._device_align(dc, da, dl)
    sharded = sharded_align_step(make_mesh(devices=CPU4), al)(codes, ambig, lens)
    assert sorted(sharded) == sorted(single)
    for k in single:
        assert sharded[k].dtype == single[k].dtype, k
        assert torch.equal(sharded[k], single[k]), k

    ja = JAligner(g, idx, cfg)
    j_single = jax.device_get(ja._device_align(
        jnp.asarray(codes), jnp.asarray(ambig), jnp.asarray(lens),
        ja.d_bucket_start, ja.d_comb, ja.d_sub_base, ja.d_sub_lo, ja.d_genome))
    j_sharded = jax.device_get(jmesh.sharded_align_step(
        jmesh.make_mesh(4, devices=jax_cpus[:4]), ja)(codes, ambig, lens))
    for j in (j_single, j_sharded):
        assert sorted(j) == sorted(sharded)
        for k in j:
            np.testing.assert_array_equal(_host(k, sharded[k]), np.asarray(j[k]),
                                          err_msg=k)

    if case == "saturated-past-tiers":
        # more saturated reads than the tiers hold: some keep the flag for
        # the host pass, and per-part folds (each part's own compaction)
        # would have rescued them on the device instead
        view = copy.copy(al)
        view.rescue_fold_cap = 0
        assert int(view._device_align(dc, da, dl)["saturated"].sum()) > al.rescue_fold_cap
        assert int(single["saturated"].sum()) > 0
        per = n // 4
        parts = [al._device_align(dc[i * per:(i + 1) * per], da[i * per:(i + 1) * per],
                                  dl[i * per:(i + 1) * per]) for i in range(4)]
        naive_sat = torch.cat([p["saturated"] for p in parts])
        assert int(naive_sat.sum()) < int(single["saturated"].sum())
        # ... and after the host pass (collect_batch's) the two agree on every
        # key the host reads: the tiers are width-exact here; probe_kv rows
        # differ only where no read is flagged for host indel placement
        batch = synthetic_reads(g, n, seed=6)
        whole = _merge_parts([_host_part(single)], n, 0)
        naive = _merge_parts([_host_part(p) for p in parts], n, 0)
        al._rescue_saturated(batch, whole)
        al._rescue_saturated(batch, naive)
        for k in whole:
            if k != "probe_kv":
                np.testing.assert_array_equal(whole[k], naive[k], err_msg=k)
        rows = (whole["probe_kv"] != naive["probe_kv"]).any(1)
        assert not (rows & ((whole["indel"] != 0) | whole["multi_indel"])).any()


def test_index_sharded_vote_equals_block_fold_and_jax(genomes, jax_cpus):
    g, idx = genomes["plain"]
    params = VoteParams()
    shards = tshard.split_index_shards(idx, 2)
    assert len(shards) == 2 and sum(s.n_items for s in shards) >= idx.n_items
    bs, cb, sb, sl, bits, sbits = tshard.stack_shards(shards)
    j_stacked = jshard.stack_shards(jshard.split_index_shards(idx, 2))
    for a, b in zip((bs, cb, sb, sl, bits, sbits), j_stacked):
        np.testing.assert_array_equal(a, b)
    b = synthetic_reads(g, 256, seed=8)
    codes, ambig, lens = b.codes, b.ambig, b.lengths.astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    acc = None
    for s in range(2):
        v = vote_batch(t(codes), t(ambig), t(lens), t(bs[s].astype(np.int32)),
                       t(cb[s].view(np.int32)), bits, params,
                       sub_base=t(sb[s].astype(np.int32)),
                       sub_lo=t(sl[s].astype(np.int32)), sub_bits=sbits)
        acc = v if acc is None else merge_vote_results(acc, v, params)

    mesh = tshard.make_mesh_2d(2, 2, CPU4)
    placed = tshard.place_sharded_index(mesh, bs, cb, sb, sl)
    got = tshard.index_sharded_vote(mesh, bits, params, sub_bits=sbits)(
        codes, ambig, lens, *placed)

    jm = jshard.make_mesh_2d(2, 2, jax_cpus[:4])
    jgot = jax.device_get(jshard.index_sharded_vote(jm, bits, jvote.VoteParams(),
                                                    sub_bits=sbits)(
        jnp.asarray(codes), jnp.asarray(ambig), jnp.asarray(lens),
        *jshard.place_sharded_index(jm, bs, cb, sb, sl)))
    for f in acc._fields:
        assert torch.equal(getattr(got, f), getattr(acc, f)), f
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(jgot, f)).astype(
                getattr(got, f).numpy().dtype), err_msg=f)
    assert int(got.votes[:, 0].gt(0).sum()) > 200


@pytest.fixture(scope="module")
def fc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fc")
    rng = np.random.default_rng(17)
    # neither record count divides by the 4-device mesh
    return dict(gtf=write_gtf(d / "g.gtf", rng),
                se=write_sam(d / "se.sam", rng, n=2900),
                pe=write_sam(d / "pe.sam", rng, n=1501, paired=True), dir=d)


@pytest.mark.parametrize("strand,paired", [(0, False), (1, False), (2, True)])
def test_count_sharded_equals_count_and_jax(fc_data, jax_cpus, strand, paired):
    ann = load_annotation(fc_data["gtf"])
    dc = tdc.DeviceCounter(ann, strand=strand, max_sections=20 if paired else 10,
                           device="cpu")
    secs = (dc.fragments_from_sam if paired else dc.sections_from_sam)(
        fc_data["pe" if paired else "se"])
    assert len(secs[2]) % 4
    c, s, _, ov = dc.count(*secs)
    cs, ss, ovs = dc.count_sharded(make_mesh(devices=CPU4), *secs)
    np.testing.assert_array_equal(cs, c)
    np.testing.assert_array_equal(ss, s)
    assert cs.dtype == c.dtype and ss.dtype == s.dtype and ovs == ov == 0

    jd = jdc.DeviceCounter(jload(fc_data["gtf"]), strand=strand,
                           max_sections=20 if paired else 10)
    jc, js, jov = jd.count_sharded(jax.sharding.Mesh(np.array(jax_cpus[:4]), ("reads",)),
                                   *secs)
    np.testing.assert_array_equal(cs, jc)
    np.testing.assert_array_equal(ss, js)
    assert jov == ovs


def test_featurecounts_mesh_branch(fc_data, monkeypatch, capfd):
    """--deviceCounts over a mesh writes the single-device files and says on
    how many devices it counted."""
    d = fc_data["dir"]
    argv = lambda out: ["--deviceCounts", "--device", "cpu", "-a", fc_data["gtf"],
                        "-o", str(d / out), fc_data["se"]]
    assert tcli.device_mesh(torch.device("cpu")) is None
    assert tcli.main(argv("one.txt")) == 0
    monkeypatch.setattr(tcli, "device_mesh", lambda device: make_mesh(devices=CPU4))
    assert tcli.main(argv("mesh.txt")) == 0
    err = capfd.readouterr().err
    assert "counted on cpu" in err and "counted on 4 devices" in err
    for suf in ("", ".summary"):
        one = (d / f"one.txt{suf}").read_text().split("\n", 1)[1]
        mesh = (d / f"mesh.txt{suf}").read_text().split("\n", 1)[1]
        assert one.replace("one.txt", "") == mesh.replace("mesh.txt", "")


def test_map_long_reads_sharded_equals_single_and_jax(jax_cpus):
    g = synthetic_genome(500_000, seed=11)
    idx = build_hash_index(g, index_gap=1)
    reads = synthetic_long_reads(g, 5, seed=12, max_len=6000, del_frac=0.4)
    codes = [reads.codes[i, :reads.lengths[i]] for i in range(len(reads))]
    cfg = aligner_config(batch_reads=256, min_votes=2)
    al = Aligner(g, idx, cfg, device="cpu")
    single = tlong.map_long_reads(al, codes)
    sharded = tlong.map_long_reads_sharded(al, codes, make_mesh(devices=CPU4))
    ja = JAligner(g, idx, cfg)
    jsharded = jlong.map_long_reads_sharded(
        ja, codes, jmesh.make_mesh(4, devices=jax_cpus[:4]))
    assert [h.__dict__ for h in sharded] == [h.__dict__ for h in single]
    assert [h.__dict__ for h in sharded] == [h.__dict__ for h in jsharded]
    assert sum(h.mapped for h in sharded) >= 4


def test_mesh_over_absent_cards_raises():
    from subread_tpu_torch.parallel.mesh import mesh_devices

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        make_mesh(have + 1)
    with pytest.raises(RuntimeError):
        make_mesh(devices=[f"cuda:{have}"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        tshard.make_mesh_2d(2, 2, ["cpu"] * 3)
    assert mesh_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_shard_batch_and_replicate():
    from subread_tpu_torch.parallel.mesh import replicate, shard_batch

    mesh = make_mesh(devices=CPU4)
    assert mesh.shape == {"reads": 4} and mesh.size == 4
    assert mesh.distinct() == [torch.device("cpu")]
    (parts,) = shard_batch(mesh, np.arange(8))
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        shard_batch(mesh, np.zeros(6))
    (copies,) = replicate(mesh, np.arange(3))
    assert list(copies) == [torch.device("cpu")] and copies[torch.device("cpu")].tolist() == [0, 1, 2]


def test_scaling_harness_runs_on_named_devices_and_never_falls_back(capsys):
    from subread_tpu_torch.parallel import scaling

    res = scaling.measure_sharding_overhead((1, 2), total_reads=256, reps=1,
                                            devices=["cpu", "cpu"])
    assert sorted(res) == [1, 2] and res[1]["overhead"] == 1.0
    assert res[2]["reads"] == 256 and res[2]["step_s"] > 0
    assert res[1]["bit_equal"] and res[2]["bit_equal"]
    assert scaling.main(["--devices", "1,2", "--devices-list", "cpu,cpu",
                         "--reads", "128", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert '"metric": "weak_scaling_efficiency"' in out and '"bit_equal": true' in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="visible"):
            scaling.measure_weak_scaling((1,), per_device_reads=64, reps=1)

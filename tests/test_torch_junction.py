"""The port's junction ops (subread_tpu_torch/ops/junction.py and
ops/extend.py::softclip_bounds) against the JAX package's, function by
function: on VoteResults from real votes on spliced reads, on random
tables rich in ties (equal votes, coverage spans, positions and table keys,
SENTINEL rows and slots, equal right edges), and on event tables padded with
SENTINEL to a power of two.  Every output is an integer or a bool: the
tolerance is 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import subread_tpu.ops.extend as jext
import subread_tpu.ops.junction as jj
import subread_tpu.ops.vote as jv
from subread_tpu.config import subjunc_config
from subread_tpu.index.build import build_hash_index
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.ops import extend as text
from subread_tpu_torch.ops import junction as tj
from subread_tpu_torch.ops.extend import oriented_read
from subread_tpu_torch.ops.vote import VoteResult, vote_batch
from subread_tpu_torch.synth import synthetic_genome, synthetic_spliced_reads

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

GENOME = dict(n_bases=200_000, seed=5, tandem_frac=0.05, segdup_len=2000)
SEN = 0xFFFFFFFF
U32_FIELDS = ("pos", "tail", "anchor", "probe_kv")
R, K = 256, 8


@pytest.fixture(scope="module")
def genome():
    return synthetic_genome(**GENOME)


@pytest.fixture(scope="module")
def aligner(genome):
    index = build_hash_index(genome, index_gap=1)
    return Aligner(genome, index, subjunc_config(batch_reads=512), device="cpu")


@pytest.fixture(scope="module")
def real(genome, aligner):
    """Votes, candidate scores and oriented reads of 512 spliced reads
    (short flanks, two-intron reads, chimeras included), from the port's
    own vote and scoring (held to JAX's by the other test files)."""
    b, truth = synthetic_spliced_reads(genome, 512, seed=13, chimera_frac=0.05)
    codes = np.zeros((512, 128), np.uint8)
    codes[:, :100] = b.codes
    ambig = np.zeros((512, 128), bool)
    ambig[:, :100] = b.ambig
    c, a, l = (torch.from_numpy(x) for x in (codes, ambig, b.lengths.astype(np.int32)))
    blk = aligner.dev_index.blocks[0]
    vote = vote_batch(c, a, l, blk.bucket_start, blk.comb, blk.bucket_bits,
                      aligner.vote_params, static_len=100,
                      sub_base=blk.sub_base, sub_lo=blk.sub_lo,
                      sub_bits=blk.sub_bits, search_steps=blk.search_steps)
    sc = aligner._score_candidates(c, a, l, vote, uniform_len=100)
    return dict(codes=c, lens=l, v=vote, sc=sc, truth=truth, batch=b)


# --- conversions ------------------------------------------------------------

def to_jax(t: torch.Tensor, u32: bool = False):
    a = t.numpy()
    return jnp.asarray(a.astype(np.uint32) if u32 else a)


def vote_to_jax(v: VoteResult):
    return jv.VoteResult(**{
        f: to_jax(getattr(v, f), f in U32_FIELDS) for f in jv.VoteResult._fields
    })


def sc_to_jax(sc: dict) -> dict:
    return {k: to_jax(t, k == "pos_k") for k, t in sc.items()}


def assert_same(t: dict, j: dict, keys=None):
    """Same values; the same dtype but where the port carries uint32 in
    int64 or a position in int64 (best_pos)."""
    for k in keys or j:
        a = np.asarray(j[k])
        b = t[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype == np.uint32 or k == "best_pos":
            assert b.dtype == np.int64, k
        else:
            assert b.dtype == a.dtype, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64),
                                      err_msg=k)


# --- tie-rich random tables -------------------------------------------------

def random_votes(genome, seed, real_v):
    """A VoteResult of R reads x K clusters in the real one's dtypes: votes
    descending from few values; positions from a few per read (equal,
    junction-distance, beyond MAX_INTRON), SENTINEL where votes are 0, whole
    SENTINEL rows and stray SENTINEL slots; coverage spans and table keys
    from small sets, so that everything ties."""
    rng = np.random.default_rng(seed)
    votes = -np.sort(-rng.choice([0, 1, 1, 2, 3, 3, 5, 6], (R, K)), axis=1)
    st = np.asarray(genome.starts, np.int64)
    base = st[rng.integers(0, len(st), R)] + rng.integers(1000, 40_000, R)
    pool = base[:, None] + rng.choice([0, 0, 7, 300, 2000, 600_000], (R, 4))
    pos = np.take_along_axis(pool, rng.integers(0, 4, (R, K)), 1)
    pos = np.where(votes > 0, pos, SEN)
    pos[rng.random(R) < 0.05] = SEN                       # empty reads
    stray = rng.random((R, K)) < 0.03
    pos[stray] = SEN
    cov_s = rng.choice([0, 4, 10, 20, 40, 50], (R, K))
    cov_e = cov_s + rng.choice([16, 30, 40, 50], (R, K))
    anchor = np.where(pos != SEN, pos + rng.choice([0, 0, 3, 11], (R, K)), SEN)
    apk = np.where(pos != SEN, rng.choice([0, 1, 1, 2, 3], (R, K)), 1 << 29)
    dt = {f: getattr(real_v, f).dtype for f in VoteResult._fields}
    t = lambda a, f: torch.from_numpy(np.asarray(a)).to(dt[f])
    v = VoteResult(
        pos=t(pos, "pos"), tail=t(pos, "tail"), anchor=t(anchor, "anchor"),
        votes=t(votes, "votes"), strand=t(rng.integers(0, 2, (R, K)), "strand"),
        cov_start=t(cov_s, "cov_start"), cov_end=t(cov_e, "cov_end"),
        probe_kv=torch.full((R, K, 2), SEN, dtype=torch.int64),
        saturated=torch.zeros(R, dtype=torch.bool), apk=t(apk, "apk"),
    )
    valid = (votes >= 1) & (pos != SEN)
    score = np.where(valid, rng.choice([100, 200, 200, 300], (R, K)), -1)
    sc = dict(score_k=torch.from_numpy(score.astype(np.int32)),
              valid_k=torch.from_numpy(valid),
              pos_k=v.pos)
    lens = torch.from_numpy(rng.choice([100, 100, 100, 60, 0], R).astype(np.int32))
    return v, sc, lens


def tables(genome, real, seed):
    """(name, VoteResult, sc, lens) for the real votes and a random table."""
    v, sc, lens = random_votes(genome, seed, real["v"])
    return [("real", real["v"], real["sc"], real["lens"]),
            ("random", v, sc, lens)]


# --- the tests --------------------------------------------------------------

def test_softclip_bounds_matches_jax():
    rng = np.random.default_rng(3)
    for density in (0.02, 0.1, 0.3, 0.6):
        mm = rng.random((R, 130)) < density
        mm[:8] = False                    # clean reads
        mm[8:16, :40] = True              # one dirty end
        mm[16:24, 60:] = True
        lens = rng.choice([130, 100, 40, 16, 0], R).astype(np.int32)
        cl, cr = text.softclip_bounds(torch.from_numpy(mm), torch.from_numpy(lens))
        jcl, jcr = jext.softclip_bounds(jnp.asarray(mm), jnp.asarray(lens))
        assert_same(dict(cl=cl, cr=cr), dict(cl=jcl, cr=jcr))


@pytest.mark.parametrize("seed", [1, 2])
def test_pick_junction_pair_matches_jax(genome, real, seed):
    for name, v, sc, lens in tables(genome, real, seed):
        vj, scj = vote_to_jax(v), sc_to_jax(sc)
        for best in (None, "alt"):
            b = None
            if best:   # a paired selection's choice: any index
                b = torch.from_numpy(
                    np.random.default_rng(seed).integers(0, K, len(lens)).astype(np.int32))
            for max_indel in (5, 16):
                t = tj.pick_junction_pair(v, sc, max_indel, best=b, read_len=lens)
                j = jj.pick_junction_pair(
                    vj, scj, max_indel, best=None if b is None else to_jax(b),
                    read_len=to_jax(lens))
                assert_same(t, j)
        if name == "real":
            assert t["valid"].sum() > 20      # real junction pairs among them


@pytest.mark.parametrize("seed", [3, 4])
def test_candidate_structure_matches_jax(genome, real, seed):
    for name, v, sc, lens in tables(genome, real, seed):
        vj = vote_to_jax(v)
        for mvs, ms in ((1, 3), (2, 3), (1, 64)):
            t = tj.candidate_structure(v, lens, mvs, ms)
            j = jj.candidate_structure(vj, to_jax(lens), mvs, ms)
            assert_same(t, j)
        amb = tj.big_margin_ambiguous(v, lens, 1)
        np.testing.assert_array_equal(
            amb.numpy(), np.asarray(jj.big_margin_ambiguous(vj, to_jax(lens), 1)))
        if name == "random":
            assert t["amb"].any() and t["has_slot"][:, 2].any()


@pytest.mark.parametrize("seed", [5, 6])
def test_pick_stored_seed_junctions_matches_jax(genome, real, seed):
    for name, v, sc, lens in tables(genome, real, seed):
        vj, scj = vote_to_jax(v), sc_to_jax(sc)
        for mv, ms in ((1, 3), (1, 64), (3, 3)):
            t = tj.pick_stored_seed_junctions(
                v, sc, 5, lens, sc["valid_k"], min_votes=mv,
                min_votes_second=1, max_simples=ms)
            j = jj.pick_stored_seed_junctions(
                vj, scj, 5, to_jax(lens), scj["valid_k"], min_votes=mv,
                min_votes_second=1, max_simples=ms)
            assert_same(t, j)
        assert t["valid"].any()


def test_junction_split_scan_matches_jax(genome, aligner, real):
    """Across the pairs pick_junction_pair finds on the real votes, and
    across random (head, gap) rows: SENTINEL and wrapping heads, negative
    and huge gaps, random guess windows, with and without them."""
    gw = aligner.dev_index.genome_words
    gj = to_jax(gw, True)
    v, sc, lens, codes = real["v"], real["sc"], real["lens"], real["codes"]
    pair = tj.pick_junction_pair(v, sc, 5, read_len=lens)
    strand = torch.gather(v.strand, 1, torch.argmax(sc["score_k"], 1)[:, None])[:, 0]
    o = oriented_read(codes, lens, strand, 100)
    rng = np.random.default_rng(9)
    n = len(lens)
    rand = dict(
        head_pos=torch.from_numpy(np.where(
            rng.random(n) < 0.1, rng.choice([SEN, SEN - 5, 0, 3], n),
            rng.integers(0, genome.total - 200, n)).astype(np.int64)),
        gap=torch.from_numpy(rng.choice([-40, 0, 60, 700, 5000, 1 << 30], n).astype(np.int32)),
        valid=torch.from_numpy(rng.random(n) < 0.8),
        guess_lo=torch.from_numpy(rng.integers(-10, 80, n).astype(np.int32)),
        guess_hi=torch.from_numpy(rng.integers(20, 120, n).astype(np.int32)),
    )
    found = 0
    for p in (pair, rand):
        for guess in (True, False):
            args = (p["head_pos"], p["gap"], p["valid"])
            g = (p["guess_lo"], p["guess_hi"]) if guess else ()
            t = tj.junction_split_scan(gw, o, lens, *args, *g)
            j = jj.junction_split_scan(
                gj, to_jax(o), to_jax(lens), to_jax(args[0], True),
                to_jax(args[1]), to_jax(args[2]), *(to_jax(x) for x in g))
            assert_same(t, j)
            found += int(t["ok"].sum())
            if p is pair and guess:
                assert (t["ok"] & (t["clip_l"] + t["clip_r"] > 0)).any() or t["ok"].sum() > 20
    assert found > 20


def test_junction_rescue_matches_jax(genome, aligner, real):
    """The event-table rescue on the real reads against the planted
    junctions (plus events sharing right edges and left edges), padded with
    SENTINEL to a power of two, from true anchors, shifted anchors,
    SENTINEL anchors and anchors on the right exon."""
    gw = aligner.dev_index.genome_words
    gj = to_jax(gw, True)
    b, truth = real["batch"], real["truth"]
    names = {n: i for i, n in enumerate(genome.names)}
    keys = sorted(truth["junctions"])
    lefts = [genome.chro_to_linear(names[c], le) for c, le, re_, _ in keys]
    rights = [genome.chro_to_linear(names[c], re_) for c, le, re_, _ in keys]
    # ties: a second event on each of a few right edges and left edges
    lefts += [x - 30 for x in lefts[:5]] + lefts[5:9]
    rights += rights[:5] + [x + 40 for x in rights[5:9]]
    order = np.argsort(lefts, kind="stable")
    ev_l = np.asarray(lefts, np.uint32)[order]
    ev_r = np.asarray(rights, np.uint32)[order]
    E = 1 << max(4, int(np.ceil(np.log2(len(ev_l)))))
    pad = np.full(E - len(ev_l), SEN, np.uint32)
    ev_l, ev_r = np.concatenate([ev_l, pad]), np.concatenate([ev_r, pad])

    rng = np.random.default_rng(11)
    n = len(b)
    pos = np.full(n, SEN, np.int64)
    strand = np.zeros(n, np.int32)
    for i, name in enumerate(b.names):
        f = name.split("_")
        if f[0].startswith("sj"):
            pos[i] = genome.chro_to_linear(names[f[1]], int(f[2]) - 1)
            strand[i] = int(f[3])
    shift = rng.choice([0, 0, 0, 1, -2, 500], n)
    pos = np.where(pos != SEN, pos + shift, pos)
    pos[rng.random(n) < 0.05] = SEN
    lens = real["lens"]
    o = oriented_read(real["codes"], lens, torch.from_numpy(strand))
    t = tj.junction_rescue(gw, o, lens, torch.from_numpy(pos),
                           torch.from_numpy(ev_l.astype(np.int64)),
                           torch.from_numpy(ev_r.astype(np.int64)))
    j = jj.junction_rescue(gj, to_jax(o), to_jax(lens),
                           jnp.asarray(pos.astype(np.uint32)),
                           jnp.asarray(ev_l), jnp.asarray(ev_r))
    assert_same(t, j)
    assert t["ok"].sum() > 50

"""ops.banded_dp's plain PyTorch version against `banded_align`, on the CPU:
the batched refinement gives each segment banded_align's operations, op
for op, on random read/genome pairs with Nanopore-like substitutions and
1-5 base indels (extra band 24 and 40), on empty reads and empty genome
stretches, on length differences from 0 up to about 4,100 (bands wider
than a warp of the kernel covers), and on one batch mixing all of them,
so a short segment and a wide one share a call.  Also: the closed-form
band cells equal the rows' widths summed, and the packed table puts the
segments that need a block first.  The kernel is held to the same on a card by
tests/test_torch_banded_dp_gpu.py."""

import numpy as np
import pytest
import torch

from subread_tpu_torch.align.longread import banded_align
from subread_tpu_torch.ops import banded_dp

torch.set_num_threads(1)


def ont_like(rng, gen):
    """gen read through Nanopore-like errors: 0.6% substitutions, 0.4%
    insertions and 0.5% deletions of 1-5 bases."""
    out, i = [], 0
    while i < len(gen):
        u = rng.random()
        if u < 0.006:
            out.append((int(gen[i]) + int(rng.integers(1, 4))) % 4)
            i += 1
        elif u < 0.011:
            i += int(rng.integers(1, 6))
        elif u < 0.015:
            out.extend(rng.integers(0, 4, int(rng.integers(1, 6))).tolist())
        else:
            out.append(int(gen[i]))
            i += 1
    return np.asarray(out, np.uint8)


def band_cells_summed(n, m, extra):
    """banded_align's band cells, row by row: rows 1..n, each from
    max(1, i - band) to min(m, i + band)."""
    if n == 0 or m == 0:
        return 0
    band = abs(n - m) + extra
    i = np.arange(1, n + 1)
    return int((np.minimum(m, i + band) - np.maximum(1, i - band) + 1).sum())


def codes(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def ont_segments(rng, extra, k=40, max_len=1500):
    segs = []
    for _ in range(k):
        gen = codes(rng, int(rng.integers(1, max_len)))
        segs.append((ont_like(rng, gen), gen, extra))
    return segs


def empty_segments(rng):
    return [(codes(rng, 0), codes(rng, 37), 40), (codes(rng, 12), codes(rng, 0), 24),
            (codes(rng, 0), codes(rng, 0), 40), (codes(rng, 1), codes(rng, 1), 24),
            (codes(rng, 1), codes(rng, 300), 40), (codes(rng, 300), codes(rng, 1), 40)]


def skewed_segments(rng):
    """Length differences 0 to 4,100 either way: a genome stretch with a
    long deletion or insertion cut out of (or into) the read."""
    segs = []
    for diff in (0, 7, 60, 120, 300, 1000, 2500, 4100):
        gen = codes(rng, int(rng.integers(100, 400)) + diff)
        cut = int(rng.integers(0, len(gen) - diff + 1))
        read = ont_like(rng, np.concatenate([gen[:cut], gen[cut + diff:]]))
        segs.append((read, gen, 40))
        segs.append((gen, read, 24))     # the insertion case
    return segs


CASES = {
    "ont-extra40": lambda rng: ont_segments(rng, 40),
    "ont-extra24": lambda rng: ont_segments(rng, 24),
    "empty": empty_segments,
    "skewed": skewed_segments,
    "mixed": lambda rng: [s for f in (lambda r: ont_segments(r, 40, 15),
                                      empty_segments, skewed_segments)
                          for s in f(rng)][::-1],
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_gives_banded_aligns_operations(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    segs = CASES[case](rng)
    got = banded_dp.refine(segs, "cpu")
    assert len(got) == len(segs)
    for (read, gen, extra), ops in zip(segs, got):
        assert ops == banded_align(read, gen, extra_band=extra), (len(read), len(gen), extra)


def test_band_cells_and_the_packed_table():
    rng = np.random.default_rng(3)
    segs = empty_segments(rng) + skewed_segments(rng) + ont_segments(rng, 40, 10)
    n = np.asarray([len(r) for r, _, _ in segs])
    m = np.asarray([len(g) for _, g, _ in segs])
    extra = np.asarray([e for _, _, e in segs])
    want = [band_cells_summed(a, b, e) for a, b, e in zip(n, m, extra)]
    assert banded_dp.band_cells(n, m, np.abs(n - m) + extra).tolist() == want
    buf, order, n_wide, cells, slots = banded_dp.pack(segs)
    table = buf[: len(segs) * len(banded_dp.COLS) * 8].view(np.int64).reshape(len(segs), -1)
    width = np.minimum(table[:, 3], 2 * table[:, 4] + 1)
    assert (width[:n_wide] > banded_dp.NARROW).all()
    assert (width[n_wide:] <= banded_dp.NARROW).all() and n_wide > 0
    assert cells == sum(want) and slots == int((n + m).sum())
    assert (table[:, 2] == n[order]).all() and (table[:, 3] == m[order]).all()

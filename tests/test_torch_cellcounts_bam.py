"""cellCounts' BAM records through the native encoder (`bamrec.cpp` via
`tools/cellcounts.py::write_cell_records`) against the same records built as
SamRecords, read by read, and packed by the Python BAM writer
(`BamWriter.add_sam_fields`): byte-equal files, with CB, UB and GX tags and
without GX, on both strands and for unmapped reads, with R1s shorter than
barcode and UMI, across the writer's flush boundaries; and the same bytes
where the library is missing (the record-by-record path).  Tolerance 0."""

from types import SimpleNamespace

import numpy as np
import pytest

from subread_tpu_torch import dna, native
from subread_tpu_torch.io import sam as samio
from subread_tpu_torch.io.bam import BamWriter
from subread_tpu_torch.io.fastq import ReadBatch
from subread_tpu_torch.tools import cellcounts as cli

NAMES = ["chrA", "chrB"]
LENGTHS = [50_000, 40_000]


def batch(rng, n, lens, width, names):
    codes = rng.integers(0, 4, (n, width)).astype(np.uint8)
    quals = rng.integers(35, 75, (n, width)).astype(np.uint8)
    return ReadBatch(names=names, codes=codes, lengths=np.asarray(lens, np.int32),
                     quals=quals, ambig=np.zeros((n, width), bool))


def case(seed, n=3000):
    rng = np.random.default_rng(seed)
    names = [f"read{i}:{'x' * int(i % 7)}" for i in range(n)]
    l1 = np.where(rng.random(n) < 0.05, rng.integers(10, 28, n), 28)
    b1 = batch(rng, n, l1, 28, names)
    b2 = batch(rng, n, rng.integers(60, 91, n), 128, names)
    mapped = rng.random(n) < 0.8
    res = dict(mapped=mapped, strand=rng.integers(0, 2, n).astype(np.int8),
               mapq=rng.integers(0, 61, n).astype(np.int32))
    cidx = rng.integers(0, 2, n)
    coff = rng.integers(0, 39_000, n).astype(np.int64)
    gene = np.where(rng.random(n) < 0.6, rng.integers(0, 5, n), -1).astype(np.int32)
    gene[~mapped] = -1
    return b1, b2, res, cidx, coff, gene


def python_records(path, b1, b2, res, cidx, coff, gene, gene_names):
    """The records as SamRecords, one a read, through the Python packer."""
    w = samio.BamRecordWriter(path, NAMES, LENGTHS)
    for i in range(len(b2)):
        r1 = dna.decode(b1.codes[i, : b1.lengths[i]])
        L = int(b2.lengths[i])
        seq, qual = b2.codes[i, :L], b2.quals[i, :L].tobytes().decode()
        tags = [f"CB:Z:{r1[:16]}-1", f"UB:Z:{r1[16:28]}"]
        if gene[i] >= 0:
            tags.append(f"GX:Z:{gene_names[gene[i]]}")
        if not res["mapped"][i]:
            w.write(samio.SamRecord(b2.names[i], 4, "*", 0, 0, "*", seq=dna.decode(seq),
                                    qual=qual, tags=tags))
            continue
        rev = int(res["strand"][i]) == 1
        if rev:
            seq, qual = dna.revcomp(seq), qual[::-1]
        w.write(samio.SamRecord(b2.names[i], 16 if rev else 0, NAMES[cidx[i]],
                                int(coff[i]) + 1, int(res["mapq"][i]), f"{L}M",
                                seq=dna.decode(seq), qual=qual, tags=tags))
    w.close()


def encoded_records(path, b1, b2, res, cidx, coff, gene, gene_names):
    w = samio.BamRecordWriter(path, NAMES, LENGTHS)
    genome = SimpleNamespace(names=NAMES)
    for lo in range(0, len(b2), 1000):         # three calls, as three batches
        sl = slice(lo, lo + 1000)
        part = lambda b: ReadBatch(names=b.names[sl], codes=b.codes[sl],
                                   lengths=b.lengths[sl], quals=b.quals[sl],
                                   ambig=b.ambig[sl])
        cli.write_cell_records(w, genome, part(b1), part(b2),
                               {k: v[sl] for k, v in res.items()}, cidx[sl],
                               coff[sl], gene[sl], gene_names, 16, 12)
    w.close()


@pytest.mark.parametrize("library", ["native", "missing"])
@pytest.mark.parametrize("seed", [1, 2])
def test_cell_records_equal_the_python_packer(tmp_path, monkeypatch, seed, library):
    if library == "native" and native.get_lib() is None:
        pytest.skip("no native library")
    if library == "missing":
        monkeypatch.setattr(native, "format_bam_records", lambda *a, **k: None)
    monkeypatch.setattr(BamWriter, "FLUSH_BYTES", 1 << 16)
    genes = ["G1", "GENE_two", "g3.long_name_of_a_gene", "X", "G5"]
    args = case(seed)
    python_records(str(tmp_path / "py.bam"), *args, genes)
    encoded_records(str(tmp_path / "enc.bam"), *args, genes)
    assert (tmp_path / "enc.bam").read_bytes() == (tmp_path / "py.bam").read_bytes()
    # the reader sees every record with the tags it should carry
    from subread_tpu_torch.io.bam import BamReader

    recs = list(BamReader(str(tmp_path / "enc.bam")))
    b1, _, res, _, _, gene = args
    assert len(recs) == len(b1)
    assert sum("GX" in r.tags for r in recs) == int((gene >= 0).sum()) > 1000
    assert all(len(r.tags["UB"]) == max(min(int(n) - 16, 12), 0)
               for r, n in zip(recs, b1.lengths))
    assert {r.flag for r in recs} == {0, 4, 16}

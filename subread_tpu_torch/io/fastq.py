"""Copy of `subread_tpu/io/fastq.py`: the port imports nothing of the JAX package.

FASTQ reading into dense batches.

Reference equivalent: the FASTQ arm of `gene_input_t`
(`geinput_next_read`, input-files.c:768) plus quality-format detection
(`guess_reads_density_format`, input-files.h:283).

TPU-first design: instead of a per-read streaming API, reads are parsed into
fixed-shape dense batches (codes [N, Lmax] uint8, lengths, quals) that upload
straight to HBM.  Chunk replay (the reference's geinput_tell/seek, used to
re-scan each chunk once per index block and once for realignment) becomes
simply keeping the parsed chunk in host RAM.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field

import numpy as np

from .. import dna, timing


@dataclass
class ReadBatch:
    """A dense batch of reads. codes are A=0,G=1,C=2,T=3; pad value 0."""

    names: list[str]
    codes: np.ndarray   # uint8 [n, max_len]
    lengths: np.ndarray  # int32 [n]
    quals: np.ndarray   # uint8 [n, max_len] raw ASCII phred bytes (0 = pad)
    ambig: np.ndarray   # bool [n, max_len]; True at N / non-ACGT

    def __len__(self) -> int:
        return len(self.names)

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


def _open_maybe_gz(path: str):
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        f.close()
        return gzip.open(path, "rb")
    return f


def batch_from_records(
    names: list[str], seqs: list[bytes], quals: list[bytes], pad_to: int | None = None
) -> ReadBatch:
    n = len(names)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=n)
    max_len = int(lens.max()) if n else 0
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    codes = np.zeros((n, max_len), dtype=np.uint8)
    qarr = np.zeros((n, max_len), dtype=np.uint8)
    amb = np.zeros((n, max_len), dtype=bool)
    # Vectorised fill: concatenate all bytes once, LUT-encode, then scatter.
    if n:
        flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
        enc = dna.BASE2CODE[flat]
        ambf = dna.AMBIG[flat]
        qflat = np.frombuffer(b"".join(quals), dtype=np.uint8)
        ends = np.cumsum(lens)
        starts = ends - lens
        # row/col index for each flat element
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(flat)) - np.repeat(starts, lens)
        codes[rows, cols] = enc
        amb[rows, cols] = ambf
        qarr[rows, cols] = qflat
    return ReadBatch(names=names, codes=codes, lengths=lens, quals=qarr, ambig=amb)


class FastqReader:
    """Chunked FASTQ reader (plain or gzip).  `transform(seq, qual) ->
    (seq, qual)` applies per read (trimming, color-space decode)."""

    def __init__(self, path: str, transform=None):
        self.path = path
        self._f = _open_maybe_gz(path)
        self._transform = transform

    @timing.span("fastq.read")
    def next_batch(self, max_reads: int, pad_to: int | None = None) -> ReadBatch | None:
        names: list[str] = []
        seqs: list[bytes] = []
        quals: list[bytes] = []
        f = self._f
        tf = self._transform
        for _ in range(max_reads):
            hdr = f.readline()
            if not hdr:
                break
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            if tf is not None:
                seq, qual = tf(seq, qual)
            names.append(hdr[1:].split()[0].decode())
            seqs.append(seq)
            quals.append(qual)
        if not names:
            return None
        return batch_from_records(names, seqs, quals, pad_to=pad_to)

    def close(self):
        self._f.close()


class FastaReadReader:
    """FASTA read input (gene_input_t GENE_INPUT_FASTA arm): every record
    becomes a read with uniform 'I' qualities."""

    def __init__(self, path: str, transform=None):
        self.path = path
        self._f = _open_maybe_gz(path)
        self._transform = transform
        self._pending_name: str | None = None

    def next_batch(self, max_reads: int, pad_to: int | None = None) -> ReadBatch | None:
        names, seqs, quals = [], [], []
        f = self._f
        name = self._pending_name
        chunks: list[bytes] = []

        def flush():
            if name is None:
                return
            seq = b"".join(chunks)
            qual = b"I" * len(seq)
            if self._transform is not None:
                seq, qual = self._transform(seq, qual)
            names.append(name)
            seqs.append(seq)
            quals.append(qual)

        while len(names) < max_reads:
            line = f.readline()
            if not line:
                flush()
                name = None
                break
            line = line.strip()
            if line.startswith(b">"):
                flush()
                name = line[1:].split()[0].decode()
                chunks = []
            elif name is not None:
                chunks.append(line)
        self._pending_name = name
        if not names:
            return None
        return batch_from_records(names, seqs, quals, pad_to=pad_to)

    def close(self):
        self._f.close()


_COMP = bytes.maketrans(b"ACGTacgtN", b"TGCAtgcaN")


class SamReadReader:
    """Re-alignment input: reads extracted from SAM records (the
    reference's --SAMinput/--BAMinput modes, core.c:975-1010).  Secondary/
    supplementary records are skipped; reverse-strand records are
    reverse-complemented back to original read orientation."""

    def __init__(self, path: str, transform=None, mate: int | None = None):
        self.path = path
        self._lines = self._iter_lines(path)
        self._transform = transform
        self._mate = mate  # None = all; 0/1 = first/second-in-pair only

    @staticmethod
    def _iter_lines(path):
        with open(path) as f:
            for line in f:
                if not line.startswith("@") and line.strip():
                    yield line.rstrip("\n").split("\t")

    def next_batch(self, max_reads: int, pad_to: int | None = None) -> ReadBatch | None:
        names, seqs, quals = [], [], []
        for fields in self._lines:
            flag = int(fields[1])
            if flag & 0x900:  # secondary/supplementary
                continue
            if self._mate == 0 and (flag & 0x1) and not (flag & 0x40):
                continue
            if self._mate == 1 and not (flag & 0x80):
                continue
            seq = fields[9].encode()
            qual = fields[10].encode()
            if qual == b"*":
                qual = b"I" * len(seq)
            if flag & 0x10:
                seq = seq.translate(_COMP)[::-1]
                qual = qual[::-1]
            if self._transform is not None:
                seq, qual = self._transform(seq, qual)
            names.append(fields[0])
            seqs.append(seq)
            quals.append(qual)
            if len(names) >= max_reads:
                break
        if not names:
            return None
        return batch_from_records(names, seqs, quals, pad_to=pad_to)

    def close(self):
        self._lines.close()


class BamReadReader(SamReadReader):
    """--BAMinput: same extraction over BGZF-decoded BAM records."""

    @staticmethod
    def _iter_lines(path):
        from .bam import bam_to_sam_lines

        yield from bam_to_sam_lines(path)

    def close(self):
        pass


def make_trim_transform(trim5: int = 0, trim3: int = 0, color_space: bool = False):
    """Per-read transform for --trim5/--trim3 and -b color-space decode."""
    from .. import dna as _dna

    def tf(seq: bytes, qual: bytes):
        if color_space:
            seq = _dna.colorspace_decode(seq)
            if len(qual) > len(seq):
                qual = qual[len(qual) - len(seq):]
        if trim5:
            seq, qual = seq[trim5:], qual[trim5:]
        if trim3:
            seq, qual = seq[: len(seq) - trim3], qual[: len(qual) - trim3]
        return seq, qual

    if trim5 == 0 and trim3 == 0 and not color_space:
        return None
    return tf


def open_read_source(path: str, fmt: str | None = None, transform=None,
                     mate: int | None = None):
    """Auto-detecting read-source factory (geinput_open's format sniffing,
    input-files.c:455): FASTQ/FASTA (plain or gz), SAM, BAM."""
    if fmt is None:
        with open(path, "rb") as f:
            head = f.read(4)
        if head[:2] == b"\x1f\x8b":
            import gzip as _gz

            with _gz.open(path, "rb") as f:
                inner = f.read(4)
            fmt = "BAM" if inner[:4] == b"BAM\x01" else (
                "FASTA" if inner[:1] == b">" else "FASTQ"
            )
        elif head[:1] == b">":
            fmt = "FASTA"
        elif head[:1] == b"@":
            # SAM headers start with @HD/@SQ/@RG/@PG/@CO; FASTQ names are free
            with open(path, "rb") as f:
                first = f.readline()
            fmt = "SAM" if first[1:3] in (b"HD", b"SQ", b"RG", b"PG", b"CO") \
                else "FASTQ"
        else:
            fmt = "SAM" if b"\t" in open(path, "rb").readline() else "FASTQ"
    fmt = fmt.upper()
    if fmt == "FASTA":
        return FastaReadReader(path, transform=transform)
    if fmt == "SAM":
        return SamReadReader(path, transform=transform, mate=mate)
    if fmt == "BAM":
        return BamReadReader(path, transform=transform, mate=mate)
    return FastqReader(path, transform=transform)


def read_fastq(path: str, pad_to: int | None = None) -> ReadBatch:
    r = FastqReader(path)
    try:
        batches = []
        while True:
            b = r.next_batch(1 << 20, pad_to=pad_to)
            if b is None:
                break
            batches.append(b)
    finally:
        r.close()
    if len(batches) == 1:
        return batches[0]
    if not batches:
        return batch_from_records([], [], [])
    maxlen = max(b.max_len for b in batches)

    def padto(a, fill=0):
        out = np.full((a.shape[0], maxlen), fill, dtype=a.dtype)
        out[:, : a.shape[1]] = a
        return out

    return ReadBatch(
        names=[n for b in batches for n in b.names],
        codes=np.concatenate([padto(b.codes) for b in batches]),
        lengths=np.concatenate([b.lengths for b in batches]),
        quals=np.concatenate([padto(b.quals) for b in batches]),
        ambig=np.concatenate([padto(b.ambig) for b in batches]),
    )


def guess_phred_offset(quals: np.ndarray, lengths: np.ndarray) -> int:
    """Guess 33 vs 64 phred offset from a sample of quality bytes.

    Mirrors the intent of the reference's quality-format auto-detection:
    bytes below '@' (64) can only be phred+33; an all->='@' sample with
    high minimum is phred+64.
    """
    n = min(len(lengths), 2048)
    if n == 0:
        return 33
    sample = quals[:n]
    mask = np.arange(sample.shape[1])[None, :] < lengths[:n, None]
    vals = sample[mask]
    if len(vals) == 0:
        return 33
    return 64 if int(vals.min()) >= 64 else 33

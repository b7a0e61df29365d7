"""Copy of `subread_tpu/io/sam.py`: the port imports nothing of the JAX package.

SAM record emission and parsing.

Reference equivalents: `write_single_fragment` (core.c:1888) for the output
side, `SamBam_fgets`/`PBam_chunk_gets` (sambam-file.h:195,166) for input.
Round 1 covers SAM text; the threaded BGZF/BAM writer + BAI indexing
(sambam-file.h:110-149) lands on top of the same record stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# SAM FLAG bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 1-based; 0 = unmapped
    mapq: int
    cigar: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[str] = field(default_factory=list)

    def to_line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            self.rnext,
            str(self.pnext),
            str(self.tlen),
            self.seq,
            self.qual,
        ]
        fields.extend(self.tags)
        return "\t".join(fields)


class SamWriter:
    """SAM text writer with reference-shaped header (@HD, @SQ per contig,
    @PG; optional @RG — core.c emits the same set)."""

    def __init__(
        self,
        path: str,
        contig_names: list[str],
        contig_lengths: list[int],
        rg_id: str | None = None,
        rg_extra: list[str] | None = None,
        program: str = "subread_tpu",
        version: str = "0.1.0",
        sorted_by_coord: bool = False,
    ):
        self.path = path
        self._f = open(path, "w", buffering=1 << 20)
        so = "coordinate" if sorted_by_coord else "unsorted"
        self._f.write(f"@HD\tVN:1.0\tSO:{so}\n")
        for n, l in zip(contig_names, contig_lengths):
            self._f.write(f"@SQ\tSN:{n}\tLN:{int(l)}\n")
        if rg_id:
            extra = ("\t" + "\t".join(rg_extra)) if rg_extra else ""
            self._f.write(f"@RG\tID:{rg_id}{extra}\n")
        self._f.write(f"@PG\tID:{program}\tPN:{program}\tVN:{version}\n")
        self._rg_id = rg_id

    def write(self, rec: SamRecord) -> None:
        if self._rg_id:
            rec.tags.append(f"RG:Z:{self._rg_id}")
        self._f.write(rec.to_line() + "\n")

    def write_line(self, line: str) -> None:
        self._f.write(line + "\n")

    def write_bytes(self, blob: bytes) -> None:
        self._f.flush()
        self._f.buffer.write(blob) if hasattr(self._f, "buffer") else self._f.write(
            blob.decode()
        )

    def close(self) -> None:
        self._f.close()
        from ..utils.cleanup import unregister

        unregister(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamRecordWriter:
    """SamWriter-compatible facade over io.bam.BamWriter (`bam`; the
    reference's default output is BAM, sambam-file.h:110-149)."""

    def __init__(self, path, contig_names, contig_lengths, rg_id=None,
                 rg_extra=None, program="subread_tpu", version="0.1.0",
                 sorted_by_coord=False):
        from .bam import BamWriter

        so = "coordinate" if sorted_by_coord else "unsorted"
        header = [f"@HD\tVN:1.0\tSO:{so}"]
        header += [
            f"@SQ\tSN:{n}\tLN:{int(l)}"
            for n, l in zip(contig_names, contig_lengths)
        ]
        if rg_id:
            extra = ("\t" + "\t".join(rg_extra)) if rg_extra else ""
            header.append(f"@RG\tID:{rg_id}{extra}")
        header.append(f"@PG\tID:{program}\tPN:{program}\tVN:{version}")
        self.bam = BamWriter(
            path, list(contig_names), [int(x) for x in contig_lengths],
            header_text="\n".join(header) + "\n",
        )
        self.path = path
        self._rg_id = rg_id

    def write(self, rec: "SamRecord") -> None:
        if self._rg_id:
            rec.tags.append(f"RG:Z:{self._rg_id}")
        self.bam.add_sam_fields(rec.to_line().split("\t"))

    def write_line(self, line: str) -> None:
        self.bam.add_sam_fields(line.split("\t"))

    def close(self) -> None:
        self.bam.close()
        from ..utils.cleanup import unregister

        unregister(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_writer(path, contig_names, contig_lengths, sam_output: bool,
                sort_by_coordinates: bool = False, **kw):
    # in-flight outputs are removed on SIGINT/SIGTERM/crash (reference
    # SIGINT_hook semantics, index-builder.c:996); each writer's close()
    # unregisters the path, marking the artifact valid
    from ..utils.cleanup import register

    register(path)
    if sort_by_coordinates and not sam_output:
        from .bamsort import CoordSortBamWriter

        return CoordSortBamWriter(path, contig_names, contig_lengths, **kw)
    cls = SamWriter if sam_output else BamRecordWriter
    kw["sorted_by_coord"] = sort_by_coordinates
    return cls(path, contig_names, contig_lengths, **kw)


# --- CIGAR helpers ---------------------------------------------------------

CIGAR_OPS = "MIDNSHP=X"


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    """'3M1I96M' → [(3,'M'), (1,'I'), (96,'M')] (reference
    RSubread_parse_CIGAR_string, HelperFunctions.h:99)."""
    out = []
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, ch))
            n = 0
    return out


def cigar_reference_span(cigar: str) -> int:
    """Genome bases consumed by a CIGAR (M/D/N/=/X)."""
    return sum(n for n, op in parse_cigar(cigar) if op in "MDN=X")


def cigar_read_span(cigar: str) -> int:
    """Read bases consumed by a CIGAR (M/I/S/=/X)."""
    return sum(n for n, op in parse_cigar(cigar) if op in "MIS=X")


# --- SAM reading (for featureCounts / exactSNP inputs) ---------------------


def read_sam(path: str):
    """Iterate (header_lines, records) of a SAM text file; records are raw
    field lists (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen,
    seq, qual, *tags)."""
    header = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
            elif line:
                yield line.split("\t")

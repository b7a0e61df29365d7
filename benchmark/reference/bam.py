"""A plain BAM reader: the records of a BAM file as numpy arrays.

Written from the SAM/BAM format specification (samtools' SAMv1.pdf, sections
4.1-4.2), with nothing of the program under test: BGZF is a series of gzip
members, each naming its own size in its BC extra field, and each record is
a little-endian block whose fixed fields sit at fixed offsets.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

SEQ_CHARS = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
# CIGAR operations M I D N S H P = X, and which consume the reference
REF_OPS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)
OPS = "MIDNSHP=X"


@dataclass
class Records:
    """Every record of a BAM file: raw is the inflated file and off[i] the
    offset of record i's block_size word."""
    raw: bytes
    ref_names: list[str]
    ref_lengths: list[int]
    off: np.ndarray
    ref_id: np.ndarray
    pos: np.ndarray
    l_name: np.ndarray
    n_cigar: np.ndarray
    flag: np.ndarray
    l_seq: np.ndarray
    next_ref_id: np.ndarray
    next_pos: np.ndarray
    tlen: np.ndarray

    def __len__(self) -> int:
        return len(self.off)

    def name(self, i: int) -> bytes:
        o = int(self.off[i]) + 36
        return self.raw[o: o + int(self.l_name[i]) - 1]

    def names(self) -> list[bytes]:
        raw = self.raw
        return [raw[o + 36: o + 35 + n]
                for o, n in zip(self.off.tolist(), self.l_name.tolist())]

    def cigar(self, i: int) -> list[tuple[int, int]]:
        """(length, op index into OPS) of record i's CIGAR."""
        o = int(self.off[i]) + 36 + int(self.l_name[i])
        words = struct.unpack_from(f"<{int(self.n_cigar[i])}I", self.raw, o)
        return [(w >> 4, w & 15) for w in words]

    def seq(self, i: int) -> np.ndarray:
        """Record i's bases as ASCII."""
        o = (int(self.off[i]) + 36 + int(self.l_name[i])
             + 4 * int(self.n_cigar[i]))
        n = int(self.l_seq[i])
        b = np.frombuffer(self.raw, np.uint8, (n + 1) // 2, o)
        nib = np.empty(2 * len(b), np.uint8)
        nib[0::2] = b >> 4
        nib[1::2] = b & 15
        return SEQ_CHARS[nib[:n]]

    def int_tag(self, i: int, tag: bytes) -> int | None:
        """Record i's integer tag `tag` (any integer type), or None."""
        raw = self.raw
        o = (int(self.off[i]) + 36 + int(self.l_name[i])
             + 4 * int(self.n_cigar[i]) + (int(self.l_seq[i]) + 1) // 2
             + int(self.l_seq[i]))
        end = int(self.off[i]) + 4 + struct.unpack_from("<i", raw, int(self.off[i]))[0]
        sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4, b"A": 1}
        fmt = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i", b"I": "<I"}
        while o + 3 <= end:
            t, typ = raw[o: o + 2], raw[o + 2: o + 3]
            o += 3
            if t == tag and typ in fmt:
                return struct.unpack_from(fmt[typ], raw, o)[0]
            if typ in sizes:
                o += sizes[typ]
            elif typ in (b"Z", b"H"):
                o = raw.index(b"\0", o) + 1
            elif typ == b"B":
                sub = raw[o: o + 1]
                cnt = struct.unpack_from("<I", raw, o + 1)[0]
                o += 5 + cnt * sizes[sub]
            else:
                return None
        return None

    def ref_spans(self) -> np.ndarray:
        """Reference bases each record's CIGAR consumes (0 without one)."""
        return self._cigar_sums(REF_OPS)

    def _cigar_sums(self, ops: np.ndarray) -> np.ndarray:
        n = self.n_cigar.astype(np.int64)
        total = int(n.sum())
        if total == 0:
            return np.zeros(len(self), np.int64)
        first = self.off + 36 + self.l_name
        rec = np.repeat(np.arange(len(self)), n)
        k = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
        u8 = np.frombuffer(self.raw, np.uint8)
        at = np.repeat(first, n) + 4 * k
        w = (u8[at].astype(np.uint32) | (u8[at + 1].astype(np.uint32) << 8)
             | (u8[at + 2].astype(np.uint32) << 16)
             | (u8[at + 3].astype(np.uint32) << 24))
        length = (w >> 4).astype(np.int64)
        op = (w & 15).astype(np.int64)
        use = np.where(op < len(ops), ops[np.minimum(op, len(ops) - 1)], False)
        return np.bincount(rec, weights=length * use, minlength=len(self)).astype(np.int64)


def _field(u8: np.ndarray, at: np.ndarray, width: int, signed: bool) -> np.ndarray:
    v = np.zeros(len(at), np.int64)
    for k in range(width):
        v |= u8[at + k].astype(np.int64) << (8 * k)
    if signed:
        top = np.int64(1) << (8 * width - 1)
        v = np.where(v >= top, v - (top << 1), v)
    return v


def inflate(path: str) -> bytes:
    """The BGZF file at path, inflated block by block."""
    with open(path, "rb") as f:
        data = f.read()
    parts, o, n = [], 0, len(data)
    while o < n:
        if data[o: o + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{path}: no BGZF block at byte {o}")
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        e, bsize = o + 12, None
        while e < o + 12 + xlen:
            slen = struct.unpack_from("<H", data, e + 2)[0]
            if data[e: e + 2] == b"BC":
                bsize = struct.unpack_from("<H", data, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: BGZF block at byte {o} has no BC field")
        parts.append(zlib.decompress(data[o + 12 + xlen: o + bsize - 8], -15))
        o += bsize
    return b"".join(parts)


def read_bam(path: str) -> Records:
    """Every record of the BAM file at path."""
    raw = inflate(path)
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    o = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, o)[0]
    o += 4
    names, lengths = [], []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", raw, o)[0]
        names.append(raw[o + 4: o + 3 + ln].decode())
        lengths.append(struct.unpack_from("<i", raw, o + 4 + ln)[0])
        o += 8 + ln
    offs = []
    n = len(raw)
    unpack = struct.unpack_from
    while o < n:
        offs.append(o)
        o += 4 + unpack("<i", raw, o)[0]
    if o != n:
        raise ValueError(f"{path}: the last record runs past the end")
    off = np.asarray(offs, np.int64)
    u8 = np.frombuffer(raw, np.uint8)
    return Records(
        raw=raw, ref_names=names, ref_lengths=lengths, off=off,
        ref_id=_field(u8, off + 4, 4, True), pos=_field(u8, off + 8, 4, True),
        l_name=_field(u8, off + 12, 1, False),
        n_cigar=_field(u8, off + 16, 2, False),
        flag=_field(u8, off + 18, 2, False),
        l_seq=_field(u8, off + 20, 4, True),
        next_ref_id=_field(u8, off + 24, 4, True),
        next_pos=_field(u8, off + 28, 4, True),
        tlen=_field(u8, off + 32, 4, True),
    )

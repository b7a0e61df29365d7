"""Copy of `subread_tpu/io/bam.py`: the port imports nothing of the JAX package.

BAM / BGZF codec (host-side, zlib).

Reference: sambam-file.c — BGZF chunk reader (`SamBam_fgets`,
sambam-file.h:195), threaded BGZF writer (+BAI) (sambam-file.h:110-149),
bin⇄SAM record conversion (:225).  Python implementation; the BGZF
deflate path moves to the C++ host library when output throughput
demands it.  The port adds `BamWriter.add_records`, which appends records
its native encoder packed (`native/bamrec.cpp`).
"""

from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import timing

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

# BAM encodes bases in 4-bit =ACMGRSVTWYHKDBN order
BAM_SEQ_CHARS = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"


def _bgzf_blocks(raw: bytes):
    """Yield decompressed data of each BGZF block."""
    off = 0
    n = len(raw)
    while off < n:
        if raw[off : off + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at {off}")
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        extra = raw[off + 12 : off + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("no BC subfield in BGZF block")
        comp = raw[off + 12 + xlen : off + bsize - 8]
        data = zlib.decompress(comp, -15)
        yield data
        off += bsize


def bgzf_decompress(path: str, threads: int | None = None) -> bytes:
    """Whole-file BGZF inflate.

    Blocks are independent deflate streams (the reference reads them
    serially, SamBam_fgets sambam-file.h:195); the native path
    (native/bgzf.cpp) scans block boundaries once and inflates all blocks
    with a C++ thread pool into one preallocated buffer.  Python block
    loop as fallback."""
    from .. import native

    with open(path, "rb") as f:
        raw = f.read()
    out = native.bgzf_inflate(raw, threads or 0)
    if out is not None:
        return out
    return b"".join(_bgzf_blocks(raw))


def _bgzf_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25 + 1
    return (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00BC\x02\x00"
        + struct.pack("<H", bsize - 1)
        + comp
        + struct.pack("<I", zlib.crc32(payload))
        + struct.pack("<I", len(payload))
    )


def bgzf_compress_chunks(data: bytes, level: int = 5, threads: int | None = None):
    """Yield BGZF blocks (<=64KB payload each) for `data`.

    Deflate runs on a worker pool for large buffers — the reference's
    master/worker BGZF compressor (sambam-file.h:131-148,
    worker_master_mutex_t); zlib releases the GIL so Python threads give
    real parallel compression.  Blocks are yielded in order.
    """
    CHUNK = 0xFF00
    payloads = [data[i : i + CHUNK] for i in range(0, len(data) or 1, CHUNK)]
    if len(payloads) >= 8:
        import concurrent.futures as cf
        import os

        n = threads or min(8, os.cpu_count() or 1)
        with cf.ThreadPoolExecutor(max_workers=n) as pool:
            yield from pool.map(
                _bgzf_block, payloads, [level] * len(payloads), chunksize=4
            )
    else:
        for payload in payloads:
            yield _bgzf_block(payload, level)


@dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos: int          # 0-based
    mapq: int
    cigar: list[tuple[int, str]]
    next_ref_id: int
    next_pos: int
    tlen: int
    seq: str
    qual: bytes
    tags: dict[str, object] = field(default_factory=dict)

    @property
    def cigar_str(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{n}{op}" for n, op in self.cigar)


def _parse_tags(buf: bytes) -> dict[str, object]:
    tags: dict[str, object] = {}
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off : off + 2].decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(buf[off]); off += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, off)[0]; off += 1
        elif typ == "C":
            tags[tag] = buf[off]; off += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, off)[0]; off += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, off)[0]; off += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, off)[0]; off += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, off)[0]; off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, off)[0]; off += 4
        elif typ in "ZH":
            end = buf.index(0, off)
            tags[tag] = buf[off:end].decode(); off = end + 1
        elif typ == "B":
            sub = chr(buf[off]); cnt = struct.unpack_from("<I", buf, off + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            off += 5 + cnt * size
            tags[tag] = None  # array tags skipped
        else:
            break
    return tags


class BamReader:
    """Whole-file BAM reader (decompress once, parse records)."""

    def __init__(self, path: str):
        data = bgzf_decompress(path)
        if data[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        self.header_text = data[8 : 8 + l_text].rstrip(b"\x00").decode(errors="replace")
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.ref_names: list[str] = []
        self.ref_lengths: list[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4 : off + 4 + l_name - 1].decode()
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            self.ref_names.append(name)
            self.ref_lengths.append(l_ref)
            off += 8 + l_name
        self._data = data
        self._off = off

    def __iter__(self):
        data = self._data
        off = self._off
        n = len(data)
        while off + 4 <= n:
            block_size = struct.unpack_from("<i", data, off)[0]
            rec = data[off + 4 : off + 4 + block_size]
            off += 4 + block_size
            (
                ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
                next_ref, next_pos, tlen,
            ) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
            p = 32
            qname = rec[p : p + l_read_name - 1].decode()
            p += l_read_name
            cigar = []
            for i in range(n_cigar):
                v = struct.unpack_from("<I", rec, p + 4 * i)[0]
                cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
            p += 4 * n_cigar
            nseq = (l_seq + 1) // 2
            seq_bytes = rec[p : p + nseq]
            chars = []
            for i in range(l_seq):
                b = seq_bytes[i // 2]
                code = (b >> 4) if i % 2 == 0 else (b & 0xF)
                chars.append(BAM_SEQ_CHARS[code])
            seq = "".join(chars)
            p += nseq
            qual = rec[p : p + l_seq]
            p += l_seq
            tags = _parse_tags(rec[p:])
            yield BamRecord(
                qname=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
                cigar=cigar, next_ref_id=next_ref, next_pos=next_pos,
                tlen=tlen, seq=seq, qual=qual, tags=tags,
            )

    def to_sam_fields(self, rec: BamRecord) -> list[str]:
        """BAM record → SAM text fields (bin2SAM, sambam-file.h:225)."""
        rname = self.ref_names[rec.ref_id] if rec.ref_id >= 0 else "*"
        rnext = (
            "=" if rec.next_ref_id == rec.ref_id and rec.ref_id >= 0
            else (self.ref_names[rec.next_ref_id] if rec.next_ref_id >= 0 else "*")
        )
        qual = (
            "".join(chr(q + 33) for q in rec.qual)
            if rec.qual and rec.qual[0] != 0xFF
            else "*"
        )
        fields = [
            rec.qname, str(rec.flag), rname, str(rec.pos + 1), str(rec.mapq),
            rec.cigar_str, rnext, str(rec.next_pos + 1), str(rec.tlen),
            rec.seq or "*", qual,
        ]
        for tag, val in rec.tags.items():
            if val is None:
                continue
            if isinstance(val, int):
                fields.append(f"{tag}:i:{val}")
            elif isinstance(val, float):
                fields.append(f"{tag}:f:{val}")
            elif isinstance(val, str) and len(val) == 1 and tag in ("XS",):
                fields.append(f"{tag}:A:{val}")
            else:
                fields.append(f"{tag}:Z:{val}")
        return fields


def cigar_ops(cigar: str) -> list[int]:
    """A SAM CIGAR string as BAM's u32 operations (length << 4 | op); "*"
    gives none."""
    ops = []
    if cigar != "*":
        num = 0
        for ch in cigar:
            if ch.isdigit():
                num = num * 10 + ord(ch) - 48
            else:
                ops.append((num << 4) | CIGAR_OPS.index(ch))
                num = 0
    return ops


class BamWriter:
    """Minimal BAM writer: header + records, BGZF-compressed.  While
    pack_ns is an int, the nanoseconds spent packing records, a flush
    excluded, add to it, and the records packed count in records_python
    (add_sam_fields) or records_native (add_records)."""

    FLUSH_BYTES = 1 << 22   # records buffered before a deflate
    pack_ns: int | None = None
    records_python = records_native = 0

    def __init__(self, path: str, ref_names: list[str], ref_lengths: list[int],
                 header_text: str = ""):
        self._f = open(path, "wb")
        self.ref_names = ref_names
        self._ref_idx = {n: i for i, n in enumerate(ref_names)}
        hdr = b"BAM\x01"
        text = header_text.encode()
        hdr += struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lengths):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self._buf = bytearray(hdr)

    def add_sam_fields(self, fields: list[str]) -> None:
        t0 = time.perf_counter_ns() if self.pack_ns is not None else 0
        qname = fields[0].encode() + b"\x00"
        flag = int(fields[1])
        ref_id = self._ref_idx.get(fields[2], -1)
        pos = int(fields[3]) - 1
        mapq = int(fields[4])
        ops = cigar_ops(fields[5])
        rnext = fields[6]
        next_ref = (
            ref_id if rnext == "=" else self._ref_idx.get(rnext, -1)
        )
        next_pos = int(fields[7]) - 1
        tlen = int(fields[8])
        seq = fields[9] if fields[9] != "*" else ""
        l_seq = len(seq)
        seq_nib = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq):
            code = BAM_SEQ_CHARS.find(ch.upper())
            if code < 0:
                code = 15
            if i % 2 == 0:
                seq_nib[i // 2] |= code << 4
            else:
                seq_nib[i // 2] |= code
        qual = (
            bytes(ord(c) - 33 for c in fields[10])
            if fields[10] != "*"
            else b"\xff" * l_seq
        )
        tags = b""
        for t in fields[11:]:
            tag, typ, val = t.split(":", 2)
            if typ == "i":
                tags += tag.encode() + b"i" + struct.pack("<i", int(val))
            elif typ == "A":
                tags += tag.encode() + b"A" + val.encode()[:1]
            else:
                tags += tag.encode() + b"Z" + val.encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos, len(qname), mapq,
            0, len(ops), flag, l_seq, next_ref, next_pos, tlen,
        )
        rec += qname
        rec += b"".join(struct.pack("<I", c) for c in ops)
        rec += bytes(seq_nib) + qual + tags
        self._buf += struct.pack("<i", len(rec)) + rec
        if t0:
            self.pack_ns += time.perf_counter_ns() - t0
            self.records_python += 1
        if len(self._buf) > self.FLUSH_BYTES:
            self._flush()

    def ref_ids(self, names) -> np.ndarray:
        """The header's reference ids of contig names, -1 for a name it
        does not hold."""
        return np.asarray([self._ref_idx.get(x, -1) for x in names], np.int32)

    def add_records(self, records, ends, pack_ns: int = 0) -> None:
        """Append encoded records (a buffer; ends: each record's end in
        it, ascending; pack_ns: the time their encoding took), flushing
        where add_sam_fields would have, after the first record that takes
        the buffer past FLUSH_BYTES, so the BGZF blocks are the same."""
        if self.pack_ns is not None:
            self.pack_ns += pack_ns
            self.records_native += len(ends)
        records, start, base = memoryview(records), 0, len(self._buf)
        while True:
            # the first record end past the threshold of this buffer
            j = np.searchsorted(ends, self.FLUSH_BYTES - base + start, "right")
            if j == len(ends):
                break
            self._buf += records[start:ends[j]]
            self._flush()
            start, base = int(ends[j]), 0
        self._buf += records[start:]

    @timing.span("bgzf.deflate")
    def _flush(self):
        for block in bgzf_compress_chunks(bytes(self._buf)):
            self._f.write(block)
        timing.count("bgzf.bytes_in", len(self._buf))
        self._buf = bytearray()

    def close(self):
        if self._buf:
            self._flush()
        self._f.write(BGZF_EOF)
        self._f.close()


def bam_to_sam_lines(path: str):
    """Iterate SAM text fields of a BAM file (header first as list)."""
    reader = BamReader(path)
    for rec in reader:
        yield reader.to_sam_fields(rec)

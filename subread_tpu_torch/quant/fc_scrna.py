"""Copy of `subread_tpu/quant/fc_scrna.py`: the port imports nothing of the JAX package.

featureCounts scRNA sub-mode (--scSampleSheet / --scInputMode /
--scCellBarcodeFile).

Reference: readSummary.c scRNA machinery — read-name parsing
`scRNA_scan_read_name_str` (:3761, fields split on '|': name | BC+UMI seq |
BC+UMI qual | sample seq | sample qual | lane), single-sample rule for BAM
input (:3821 "on the BAM mode, every featureCounts run only has one
sample"), per-sample output writers `scRNA_merged_to_tables_write` (:5572,
SampleTable), `scRNA_merged_write_sparse_matrix` (:5399, HighConf/RescCand
BCtab/GENEtab/spmtx triplets), `scRNA_merged_45K_to_90K_sum` (:5498,
AmbSum ambient profile over barcode ranks 45000-90000) and
`scRNA_merged_write_nozero_geneids` (:5539, no0Genes).

The UMI hamming-1 merge, knee-point bootstrap cell calling and ambient
rescue reuse quant/cellcounts.py (same algorithms in cell-counts.c).
"""

from __future__ import annotations

import numpy as np

from .cellcounts import BarcodeMatcher, call_cells, hamming1_umi_merge


def split_scrna_read_name(name: str, bc_len: int):
    """(trimmed_name, bc, umi, sample_seq, lane_str) from the '|'-joined
    scRNA read name; missing fields are None."""
    parts = name.split("|")
    trimmed = parts[0]
    bc = umi = sample_seq = lane = None
    if len(parts) > 1:
        bc = parts[1][:bc_len]
        umi = parts[1][bc_len:]
    if len(parts) > 3:
        sample_seq = parts[3]
    if len(parts) > 5:
        lane = parts[5]
        if lane.startswith("@RgLater@"):
            lane = lane[9:]
    return trimmed, bc, umi, sample_seq, lane


class ScRNACounter:
    """Per-sample (cell, gene) -> UMI accumulation for the featureCounts
    scRNA sub-mode.  BAM input mode = exactly one sample."""

    def __init__(self, barcode_list: list[str], sample_names: list[str]):
        self.matcher = BarcodeMatcher(barcode_list)
        self.sample_names = sample_names
        n = len(sample_names)
        self.reads = [0] * n
        self.mapped = [0] * n
        self.assigned = [0] * n
        # per sample: (cell_idx, gene_idx) -> {umi: reads}
        self.tables: list[dict[tuple[int, int], dict[str, int]]] = [
            {} for _ in range(n)
        ]

    def add_fragment(self, read_name: str, gene_idx: int, is_mapped: bool,
                     sample_id: int = 0):
        """One fragment: ticks counters; when assigned (gene_idx >= 0),
        accumulates the UMI under the (cell, gene) pair."""
        self.reads[sample_id] += 1
        if not is_mapped:
            return
        self.mapped[sample_id] += 1
        if gene_idx < 0:
            return
        _, bc, umi, _, _ = split_scrna_read_name(
            read_name, self.matcher.barcode_len
        )
        if not bc or not umi:
            return
        cell = self.matcher.match(bc)
        if cell < 0:
            return
        self.assigned[sample_id] += 1
        d = self.tables[sample_id].setdefault((cell, gene_idx), {})
        d[umi] = d.get(umi, 0) + 1

    # --- output writers ------------------------------------------------

    def _merged_umis(self, sample_id: int) -> dict[tuple[int, int], int]:
        """(cell, gene) -> deduped UMI count after the hamming-1 merge."""
        out = {}
        for (cell, gene), umis in self.tables[sample_id].items():
            out[(cell, gene)] = len(hamming1_umi_merge(umis))
        return out

    def _write_sparse(self, prefix: str, sample_id: int, tabtype: str,
                      cg_umis: dict, cells: list[int],
                      gene_names: list[str]):
        """One BCtab/GENEtab/spmtx triplet
        (scRNA_merged_write_sparse_matrix readSummary.c:5399)."""
        cell_set = set(cells)
        genes = sorted({
            g for (c, g), n in cg_umis.items() if c in cell_set and n > 0
        })
        total = sum(
            n for (c, g), n in cg_umis.items() if c in cell_set and n > 0
        )
        base = f"{prefix}.scRNA.{sample_id + 1:03d}.{tabtype}"
        with open(base + ".GENEtab", "w") as f:
            for g in genes:
                f.write(gene_names[g] + "\n")
        with open(base + ".BCtab", "w") as f:
            for c in cells:
                f.write(self.matcher.barcodes[c] + "\n")
        gene_rank = {g: i for i, g in enumerate(genes)}
        with open(base + ".spmtx", "w") as f:
            f.write("%%MatrixMarket matrix coordinate integer general\n")
            f.write(f"{len(genes)} {len(cells)} {total}\n")
            for ci, c in enumerate(cells):
                for g in genes:
                    n = cg_umis.get((c, g), 0)
                    if n > 0:
                        f.write(f"{gene_rank[g] + 1} {ci + 1} {n}\n")

    def write_outputs(self, prefix: str, gene_names: list[str],
                      umi_cutoff: float | None = None):
        """All scRNA output files, prefixed by the INPUT file path
        (the reference uses global_context->input_file_name)."""
        with open(f"{prefix}.scRNA.SampleTable", "w") as st:
            st.write(
                "SampleName\tUMICutoff\tTotalReads\tMappedReads"
                "\tAssignedReads\tIndex\n"
            )
            for si, sname in enumerate(self.sample_names):
                cg = self._merged_umis(si)
                cell_umis: dict[int, int] = {}
                for (c, g), n in cg.items():
                    cell_umis[c] = cell_umis.get(c, 0) + n
                called, rescued, cutoff = call_cells(cell_umis, umi_cutoff)
                st.write(
                    f"{sname}\t{cutoff}\t{self.reads[si]}"
                    f"\t{self.mapped[si]}\t{self.assigned[si]}\t{si + 1}\n"
                )
                self._write_sparse(prefix, si, "HighConf", cg, called,
                                   gene_names)
                self._write_sparse(prefix, si, "RescCand", cg, rescued,
                                   gene_names)
                # ambient profile: genes summed over barcode ranks
                # 45000-90000 (scRNA_merged_45K_to_90K_sum :5498)
                order = sorted(
                    cell_umis, key=lambda c: (-cell_umis[c], c)
                )
                amb_cells = set(order[45000:90000])
                amb: dict[int, int] = {}
                for (c, g), n in cg.items():
                    if c in amb_cells:
                        amb[g] = amb.get(g, 0) + n
                with open(f"{prefix}.scRNA.{si + 1:03d}.AmbSum", "w") as f:
                    f.write("GeneID\tUMIs\n")
                    for g in sorted(amb):
                        f.write(f"{gene_names[g]}\t{amb[g]}\n")
                no0 = sorted({g for (c, g), n in cg.items() if n > 0})
                with open(f"{prefix}.scRNA.{si + 1:03d}.no0Genes", "w") as f:
                    for g in no0:
                        f.write(gene_names[g] + "\n")

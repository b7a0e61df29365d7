"""Copy of `subread_tpu/tools/exactsnp.py`: the port imports nothing of the JAX package.

exactSNP CLI (reference SNPCalling.c:1583-1800).

Flag mapping follows the reference getopt string
"S7:N:C:a:i:g:o:bQ:p:f:n:r:x:w:s:t:T:v4" with the reference defaults
(SNPCalling.c:1626-1657).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="subread_tpu-exactSNP")
    ap.add_argument("-i", "--input", required=True, help="SAM/BAM input")
    ap.add_argument("-g", "--genome", required=True, help="reference FASTA")
    ap.add_argument("-o", "--output", required=True, help="output VCF")
    ap.add_argument("-b", "--bam", action="store_true",
                    help="input is BAM (auto-detected anyway)")
    ap.add_argument("-a", dest="known_vcf", default=None, metavar="VCF",
                    help="known-SNP annotation VCF (excluded from background)")
    ap.add_argument("-N", dest="background", default=None, metavar="FILE",
                    help="control sample SAM/BAM (adds CTRL_*/VS_QV INFO)")
    ap.add_argument("-S", dest="soft_clip", action="store_true",
                    help="vote soft-clipped bases too")
    ap.add_argument("-Q", dest="cutoff_multiplex", type=float, default=12.0,
                    help="q-value cutoff multiplex (default 12)")
    ap.add_argument("-p", dest="cutoff_upper_bound", type=float, default=5e-3,
                    help="p-value cutoff upper bound (default 5e-3)")
    ap.add_argument("-f", dest="supporting_rate", type=float, default=0.0,
                    help="min fraction of mismatched reads at a reported SNP")
    ap.add_argument("-n", dest="min_alternative", type=int, default=1,
                    help="min reads supporting an alternative allele")
    ap.add_argument("-r", dest="min_supporting", type=int, default=1,
                    help="min total reads at a reported position")
    ap.add_argument("-x", dest="max_depth", type=int, default=1_000_000,
                    help="max depth used per position (default 1000000)")
    ap.add_argument("-w", dest="testlen", type=int, default=5,
                    help="Fisher exact test window half-width (default 5)")
    ap.add_argument("-s", dest="min_phred", type=int, default=13,
                    help="min base quality phred score (default 13)")
    ap.add_argument("-t", dest="trim", type=int, default=3,
                    help="bases ignored at read head/tail (default 3)")
    ap.add_argument("-T", dest="threads", type=int, default=1)
    ap.add_argument("-C", dest="temp_dir", default=None,
                    help="temp-file directory (accepted; not needed)")
    ap.add_argument("-4", "--coverage-calc", dest="coverage_calc",
                    action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("-v", "--version", action="version",
                    version="subread_tpu-exactSNP")
    args = ap.parse_args(argv)

    from ..quant.snp import SNPCaller, SNPOptions

    import os
    for p in (args.input, args.genome):
        if not os.path.exists(p):
            print(f"ERROR: file not found: {p}", file=sys.stderr)
            return 1

    opts = SNPOptions(
        min_phred=args.min_phred,
        trim_head_tail=args.trim,
        testlen=args.testlen,
        min_alternative=args.min_alternative,
        min_supporting=args.min_supporting,
        supporting_rate=args.supporting_rate,
        cutoff_multiplex=args.cutoff_multiplex,
        cutoff_upper_bound=args.cutoff_upper_bound,
        max_depth=args.max_depth,
        use_soft_clip=args.soft_clip,
    )
    caller = SNPCaller(args.genome, opts)
    if args.known_vcf:
        caller.load_known_snps(args.known_vcf)
    caller.add_sam(args.input)
    if args.background:
        caller.set_background(args.background)
    stats = caller.write_vcf(
        args.output, cmdline=" ".join(argv or sys.argv[1:])
    )
    print(
        f"// exactSNP: {stats['snps']} SNPs, {stats['indels']} indels "
        f"-> {args.output}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

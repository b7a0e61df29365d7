"""Genomic single-end reads or pairs: frozen/synth.py's genomic_reads."""

from benchmark.frozen.synth import genomic_reads as generate  # noqa: F401

"""RNA-seq pairs across planted junctions: frozen/synth.py's spliced_pairs."""

from benchmark.frozen.synth import spliced_pairs as generate  # noqa: F401

"""Copy of `subread_tpu/quant/__init__.py`: the port imports nothing of the JAX package.

Quantification & downstream analysis (reference L5): featureCounts,
exactSNP, cellCounts."""

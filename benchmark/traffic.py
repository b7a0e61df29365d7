"""The one traffic generator: a traffic file's parameters in, a pool of
reads with their truth out.  `generator` names the generator
(`generators/<generator>.py`'s generate); every other key is its argument,
except `pool` (reads, or pairs, in the pool)."""

from __future__ import annotations

from .frozen import synth
from .spec import load_by_name


def make_pool(genome: synth.Genome, traffic: dict, seed: int,
              pool: int | None = None) -> synth.Pool:
    kw = {k: v for k, v in traffic.items() if k not in ("generator", "pool")}
    if "fragment_range" in kw:
        kw["fragment_range"] = tuple(kw["fragment_range"])
    generate = load_by_name("generators", traffic["generator"]).generate
    return generate(genome, pool or traffic["pool"], seed=seed, **kw)

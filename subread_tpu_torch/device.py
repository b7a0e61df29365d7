"""Device handling and the port's integer conventions.

Devices are explicit: every entry point takes a `device` argument and
`resolve_device` refuses "cuda" when no card is present.  Nothing falls back
to the CPU; the CPU is a device only when a caller names it (the tests do).

Dtype convention, used by every module of the port:

  * A value the JAX package holds as uint32 (16-mer keys, genome positions,
    candidate kv, packed genome words, SENTINEL) is carried in an int64
    tensor whose values lie in [0, 2**32).  Every operation at which JAX
    wraps modulo 2**32 (subtraction, addition of a negative, bitwise NOT,
    left shift) is followed by `u32`.  torch's own uint32 dtype is not used:
    on the CPU it lacks subtraction, comparison, shifts, `~`, minimum,
    cummax and floor division.
  * int32, int16, int8 and bool values keep the JAX package's dtype where a
    result reaches the host, so a result dict holds the same numpy dtypes
    after `.cpu().numpy()` (uint32 results are cast back on the host).
  * Index tensors on the device (bucket starts, sub-bucket directory,
    `comb_rows`) are int32 views of the numpy arrays; the CUDA kernel reads
    them as unsigned where the layout is unsigned.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF  # uint32 "no candidate" marker (ops.vote.SENTINEL)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def u32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor modulo 2**32 (the JAX uint32 result)."""
    return x & U32_MASK


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of uint32 values carried in int64 (torch has no
    popcount op): the SWAR bit trick, exact for values < 2**32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24


def floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log2 n) of positive int32 values, in n's dtype: JAX's
    `31 - lax.clz(n)` (torch has no clz op), by five halving steps, exact
    for every n in [1, 2**31)."""
    k = torch.zeros_like(n)
    for s in (16, 8, 4, 2, 1):
        big = n >= (1 << s)
        n = torch.where(big, n >> s, n)
        k = torch.where(big, k + s, k)
    return k


def upload(a, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device`.  To a card the copy goes through
    pinned memory without blocking, so the host can queue the next batch's
    work while earlier kernels still run."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t

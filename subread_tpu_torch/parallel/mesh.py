"""Device meshes and the data-parallel align step, on torch devices.

Port of `subread_tpu/parallel/mesh.py`.  There, a `jax.sharding.Mesh`
names the chips and the whole align step is one SPMD program whose
collectives XLA inserts.  Here a `Mesh` is an array of `torch.device`s
with axis names, and the step is driven from the host: each part of the
batch runs the single-device `Aligner._device_align` on its own device,
every part is launched before any is collected, and the parts' result
dicts are gathered in row order onto the mesh's first device.

The saturation rescue tiers are where per-part calls would differ from
one call over the whole batch: each tier compacts the saturated reads up
to a fixed capacity, so which reads a tier takes depends on the rows it
sees.  The step therefore runs the main pass per part, gathers the
saturated flags, compacts over the whole batch on the first device, as
the single-device fold and XLA's gather do, and splits the compacted rows
over the devices again for the tier's wider pass.  Results are
bit-identical to `_device_align` on the whole batch on one device.

A mesh may name one device several times (`["cpu"] * 4` in the tests,
`["cuda:0"] * 4` on one card), so every split, gather and fold runs on
real tensors with one device.  The index is uploaded once per distinct
device.  A mesh over more cards than are visible raises.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..index.device import to_device

READS_AXIS = "reads"


@dataclass(frozen=True)
class Mesh:
    """`devices`: an object array of torch.device, one axis per name."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def mesh_devices(devices) -> list[torch.device]:
    """torch.devices for a list of names or devices; a card's index is
    made explicit, and a card that is not visible raises."""
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda":
            i = torch.cuda.current_device() if d.index is None else d.index
            n = torch.cuda.device_count()
            if i >= n:
                raise RuntimeError(f"device cuda:{i} asked for; {n} visible")
            d = torch.device("cuda", i)
        out.append(d)
    return out


def device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def visible_cards(n: int | None = None) -> list[torch.device]:
    """The first n visible cards (all of them when n is None); asking for
    more cards than are visible raises."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if n < 1 or n > have:
        raise RuntimeError(f"a mesh of {n} cards asked for; {have} visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D "reads" mesh over `devices` (names or torch.devices, repeats
    allowed), by default the first `n_devices` visible cards (all when
    None)."""
    devs = visible_cards(n_devices) if devices is None else mesh_devices(devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(device_array(devs, (len(devs),)), (READS_AXIS,))


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along mesh axis `axis` (index 0 on every other axis):
    where a computation split over that axis runs."""
    a = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(a.reshape(a.shape[0], -1)[:, 0])


def tensor_on(a, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def row_blocks(n_rows: int, n_parts: int) -> list[slice]:
    """The n_parts equal consecutive blocks of a leading axis of n_rows;
    n_parts must divide n_rows, as a sharded leading axis must in JAX."""
    if n_rows % n_parts:
        raise ValueError(f"leading dimension {n_rows} is not a multiple of "
                         f"the mesh size {n_parts} along the split axis")
    per = n_rows // n_parts
    return [slice(i * per, (i + 1) * per) for i in range(n_parts)]


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's leading axis into mesh.size equal parts, part i
    on the mesh's i-th device (in flat order).  Returns one list of parts
    per array."""
    devs = list(mesh.devices.flat)
    return tuple([tensor_on(a[sl], d)
                  for sl, d in zip(row_blocks(a.shape[0], len(devs)), devs)]
                 for a in arrays)


def replicate(mesh: Mesh, *arrays):
    """One copy of each array per distinct device of the mesh: a dict
    {device: tensor} per array."""
    return tuple({d: tensor_on(a, d) for d in mesh.distinct()} for a in arrays)


def gather_rows(parts: list[dict], device: torch.device) -> dict:
    """Result dicts of consecutive row blocks, concatenated in row order
    on `device`."""
    return {k: torch.cat([p[k].to(device) for p in parts])
            for k in parts[0]}


def aligner_on(aligner, device: torch.device, dev_index=None):
    """A view of `aligner` that computes on `device` (with the index and
    genome `dev_index` already there) and leaves the rescue fold to its
    caller: the main pass only, or one tier's pass with rescue=True."""
    view = copy.copy(aligner)
    view.device = device
    if dev_index is not None:
        view.dev_index = dev_index
    elif device != mesh_devices([aligner.device])[0]:
        view.dev_index = to_device(aligner.blocks, aligner.genome, device)
    view.rescue_fold_cap = 0
    return view


def sharded_align_step(mesh: Mesh, aligner):
    """Build the mesh-sharded full align step for an Aligner.

    Returns step(codes, ambig, lens): host numpy arrays whose leading
    dimension the mesh size divides; the result dict of
    `aligner._device_align` on the whole batch, on the mesh's first
    device.  The index goes to each distinct device once, here.  Residual
    overflow past the tiers keeps its saturated flag for the host pass
    (`aligner._rescue_saturated`), as align_batch leaves it."""
    from ..align.pipeline import uniform_length

    devs = list(mesh.devices.flat)
    views = {d: aligner_on(aligner, d) for d in mesh.distinct()}
    first = devs[0]

    def split_pass(codes, ambig, lens, uniform_len, rescue, vp):
        # one tier's compacted rows, split over the devices and gathered
        chunks = zip(devs, *(torch.tensor_split(x, len(devs))
                             for x in (codes, ambig, lens)))
        return gather_rows([
            views[d]._device_align(c.to(d), a.to(d), ln.to(d),
                                   uniform_len=uniform_len, rescue=rescue,
                                   vp=vp)
            for d, c, a, ln in chunks
        ], first)

    def step(codes, ambig, lens):
        ul = uniform_length(np.asarray(lens))
        inputs, parts = [], []
        for d, sl in zip(devs, row_blocks(codes.shape[0], len(devs))):
            dc, da, dl = views[d]._upload_reads(codes[sl], ambig[sl], lens[sl])
            inputs.append(dict(codes=dc, ambig=da, lens=dl))
            parts.append(views[d]._device_align(dc, da, dl, uniform_len=ul))
        res = gather_rows(parts, first)
        if aligner.rescue_fold_cap:
            # the tiers compact over the whole batch on the first device,
            # as the single-device fold does
            x = gather_rows(inputs, first)
            res = aligner._rescue_fold(x["codes"], x["ambig"], x["lens"], res,
                                       ul, align_rows=split_pass)
        return res

    return step

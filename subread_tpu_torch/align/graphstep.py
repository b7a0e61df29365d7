"""A sub-batch's device step replayed as CUDA graphs, and read back in
stream order.

`Aligner.submit_batch` and `submit_batch_pe` queue one device step a
sub-batch (`_device_align`, `_device_align_pe`: the vote, scan-2 and the
rescue fold), thousands of small torch ops whose enqueue, one Python
dispatch each, leaves the card idle most of the time.  `StepGraphs`
records a step once per key (the step and its inputs' shapes and dtypes,
its static arguments, the device) as a chain of CUDA graphs and replays
the chain for every later sub-batch of that key.

The chain is split at each `probe_hits` launch (`ops.vote.launch_split`):
the launch stays out of every graph and runs as it does in the eager
step, through the `ops.vote.probe_hits` attribute, on copies of its inputs
that no later replay writes (whatever keeps them after the call reads that
launch's values).  Its outputs are copied into the buffers the next graph
was recorded on.  The graphs of a key share one memory pool and run in the
order they were recorded.  A replay copies the uploaded reads into the
key's input buffers first.

On a card the steps run on a stream of their own, and each step's results
are copied out of its buffers into fresh pinned host tensors right behind
it, with an event after the copies (`HostResult`).  A later replay cannot
overwrite a result before it is copied, and reading a result back waits
for its own step alone: the host's other device work (the saturation and
junction rescues, sublong's gap refinement) runs on the default stream and
does not queue behind the steps of the chunk submitted after it.

A key's first sub-batch runs the eager step, which loads every kernel the
step uses and makes the vote's constants on the device; the key is
recorded after it.  A key whose recording raises stays eager, said once on
stderr.  Tensors off a card always take the eager step, on the current
stream, with the results as it gives them.  While the profiler records,
each step counts one `submit.graph_steps` or `submit.eager_steps`, by the
path it took.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from typing import NamedTuple

import torch

from .. import timing
from ..ops import vote

MAX_KEYS = 4   # the keys kept recorded: each holds a memory pool


def _tree_map(fn, tree):
    """fn over the tensors of a step's result: a dict of tensors, or a tuple
    of them (one per mate)."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return tuple(_tree_map(fn, t) for t in tree)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.to("cpu", non_blocking=True)


class HostResult(NamedTuple):
    """A step's results on the host, and the event after their copies
    (None where the step ran off a card)."""

    value: dict | tuple
    done: torch.cuda.Event | None

    def get(self):
        """The results, once their copies have landed."""
        if self.done is not None:
            self.done.synchronize()
        return self.value


class _Recorder:
    """Records a step as graphs on one pool, ended at each probe_hits
    launch; keeps each launch's inputs, its other arguments and the
    buffers its outputs are copied into."""

    def __init__(self, device: torch.device):
        self.device = device
        self.main = torch.cuda.current_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.launches: list = []
        self.open = False

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graphs.append(g)
        self.open = True

    def end(self) -> None:
        self.open = False
        self.graphs[-1].capture_end()

    def split(self, keys, valid, orient, off, *rest):
        """In place of a probe_hits launch: end the graph, keep the launch,
        begin the next graph on buffers for its outputs."""
        self.end()
        R, P = keys.shape
        H = rest[-1]
        with torch.cuda.stream(self.main):
            kv = torch.empty((R, P * H), dtype=torch.int64, device=self.device)
            trunc = torch.empty((R, P), dtype=torch.bool, device=self.device)
        self.launches.append(((keys, valid, orient, off), rest, kv, trunc))
        self.begin()
        return kv, trunc


class _Chain:
    """A recorded step: its input buffers, graphs, launches and results."""

    def __init__(self, inputs, graphs, launches, out):
        self.inputs, self.graphs, self.launches, self.out = (
            inputs, graphs, launches, out)

    def replay(self, tensors):
        """The step on tensors; its results in the graphs' buffers, which
        the next replay overwrites."""
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)
        for i, g in enumerate(self.graphs):
            g.replay()
            if i < len(self.launches):
                ins, rest, kv, trunc = self.launches[i]
                kv_i, trunc_i = vote.probe_hits(*(t.clone() for t in ins), *rest)
                kv.copy_(kv_i)
                trunc.copy_(trunc_i)
        return self.out


class StepGraphs:
    """The recorded steps of one Aligner, at most MAX_KEYS keys, the least
    recently used dropped first, and the stream they run on."""

    def __init__(self):
        self._chains: OrderedDict = OrderedDict()   # key -> _Chain or None
        self._streams: dict = {}

    def run(self, step, tensors: tuple, **static) -> HostResult:
        """step(*tensors, **static), replayed where the key is recorded,
        else eager; on a card queued on the step stream, behind the work
        queued so far on the current one."""
        dev = tensors[0].device
        if dev.type != "cuda":
            return HostResult(self._eager(step, tensors, static), None)
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        stream = self._streams[dev]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self._on_card(step, tensors, static)
            host = _tree_map(_to_host, out)
            done = torch.cuda.Event()
            done.record()
        for t in tensors:
            t.record_stream(stream)
        return HostResult(host, done)

    def _on_card(self, step, tensors, static):
        dev = tensors[0].device
        key = (step.__name__, dev, tuple((t.shape, t.dtype) for t in tensors),
               tuple(sorted(static.items())))
        if key not in self._chains:
            out = self._eager(step, tensors, static)
            self._chains[key] = self._record(step, tensors, static)
            if len(self._chains) > MAX_KEYS:
                torch.cuda.synchronize(dev)   # no replay still reads the pool
                self._chains.popitem(last=False)
            return out
        self._chains.move_to_end(key)
        chain = self._chains[key]
        if chain is None:
            return self._eager(step, tensors, static)
        timing.count("submit.graph_steps", 1)
        return chain.replay(tensors)

    @staticmethod
    def _eager(step, tensors, static):
        timing.count("submit.eager_steps", 1)
        return step(*tensors, **static)

    @staticmethod
    def _record(step, tensors, static) -> _Chain | None:
        dev = tensors[0].device
        inputs = [t.clone() for t in tensors]
        torch.cuda.synchronize(dev)
        rec = _Recorder(dev)
        side = torch.cuda.Stream(dev)
        token = vote.launch_split.set(rec.split)
        try:
            with torch.cuda.stream(side):
                rec.begin()
                out = step(*inputs, **static)
                rec.end()
        except RuntimeError as e:
            if rec.open:
                try:
                    rec.end()
                except RuntimeError:
                    pass
            print(f"subread_tpu_torch: {step.__name__} on "
                  f"{[tuple(t.shape) for t in tensors]} {static} runs eagerly: "
                  f"its CUDA graph recording failed ({e})", file=sys.stderr)
            return None
        finally:
            vote.launch_split.reset(token)
        return _Chain(inputs, rec.graphs, rec.launches, out)

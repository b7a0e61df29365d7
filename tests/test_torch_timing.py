"""The port's timing helpers (subread_tpu_torch.timing), on the CPU."""

import math
import types

from subread_tpu_torch.timing import host_seconds, stage_ms


class Steps:
    def outer(self, x):
        return self.inner(x) + 1

    def inner(self, x):
        return 2 * x


def test_host_seconds_counts_and_restores():
    mod = types.SimpleNamespace(f=lambda x: x - 1)
    obj = Steps()
    synced = []
    orig_outer, orig_inner, orig_f = Steps.outer, Steps.inner, mod.f
    steps = [(Steps, "outer", "outer"), (Steps, "inner", "inner", True),
             (mod, "f", "f"), (obj, "outer", "obj.outer")]
    with host_seconds(steps, sync=lambda: synced.append(1)) as secs:
        assert obj.outer(3) == 7 and Steps().outer(1) == 3 and mod.f(5) == 4
    assert set(secs) == {"outer", "inner", "f", "obj.outer"}
    assert all(s > 0 for s in secs.values())
    # the nested call counts in its caller's entry too
    assert secs["outer"] >= secs["inner"]
    assert len(synced) == 2       # inner, a device step, ran twice
    assert Steps.outer is orig_outer and Steps.inner is orig_inner
    assert mod.f is orig_f and "outer" not in vars(obj)


def test_stage_ms_without_a_card():
    calls = []
    ev, wall = stage_ms(lambda: calls.append(1), reps=3, cuda=False)
    assert len(calls) == 4        # one warm-up call, then reps
    assert math.isnan(ev) and wall >= 0

"""The trace's reading: device events from the profiler's Kineto results,
and the busy time, kernels and idle gaps summarise takes from them."""

from types import SimpleNamespace

from benchmark.trace import device_events, summarise


class Event:
    def __init__(self, name, start, dur, device="CUDA"):
        self._n, self._s, self._d = name, start, dur
        self._dev = SimpleNamespace(name=device)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def fake_profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_device_events_and_summary():
    prof = fake_profile([
        Event("probe_hits_kernel", 100, 50),
        Event("Memcpy HtoD (Pageable -> Device)", 120, 100),
        Event("aten::add", 0, 1000, device="CPU"),
        Event("where_kernel", 400, 100),
    ])
    ev = device_events(prof)
    assert [(n, k) for n, _, _, k in ev] == [
        ("probe_hits_kernel", True), ("Memcpy HtoD (Pageable -> Device)", False),
        ("where_kernel", True)]
    spans = [("emit", 250, 390), ("submit", 0, 99)]
    s = summarise(ev, 0, 1000, spans, "probe_hits_kernel")
    assert s["busy_s"] == (120 + 100) / 1e9          # [100, 220] and [400, 500]
    assert s["kernels"] == 2 and s["probe_launches"] == 1
    assert s["probe_s"] == 50 / 1e9
    assert dict(s["idle_gaps"]) == {"submit": 100 / 1e9, "emit": 180 / 1e9,
                                    "host.other": 500 / 1e9}

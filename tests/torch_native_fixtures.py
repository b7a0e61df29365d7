"""Fixtures of the port's native-library tests: both packages with their
native library or without it, and a count of the records the port's
native BAM encoder packs.  Test modules import them by name."""

import pytest

import subread_tpu.native as jnative
import subread_tpu_torch.native as tnative


@pytest.fixture(params=["native", "fallback"])
def native_mode(request, monkeypatch):
    """Both packages with their native library, or both with it missing
    (the pure-Python fallback)."""
    if request.param == "fallback":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    else:
        assert jnative.get_lib() is not None and tnative.get_lib() is not None
    return request.param


@pytest.fixture()
def native_records(monkeypatch):
    """A one-item list that counts the records the port's native BAM
    encoder packs."""
    seen, encode = [0], tnative.format_bam_records

    def spy(*a, **k):
        got = encode(*a, **k)
        seen[0] += 0 if got is None else len(got[1])
        return got

    monkeypatch.setattr(tnative, "format_bam_records", spy)
    return seen

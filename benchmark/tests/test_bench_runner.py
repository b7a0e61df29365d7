"""The runner refuses to run without a card, and prints no result."""

import torch

from benchmark import run


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "align-se100-acgt.wbcel235", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_refuses_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "subjunc-pe100-acgt.wbcel235", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_unknown_workload_raises():
    import pytest

    with pytest.raises(KeyError):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])

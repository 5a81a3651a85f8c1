"""Captured fused segments through the front door over the compressed and
the journaled Level-2 stores, bit for bit the uncaptured segments (the
emulation of ``tests/_cuda_emu.py``; the cases of
``test_torch_cuda_emulated_captured.py``, split off so the workers run them
side by side).
"""
import pytest
from _captured_cases import check_captured_equal
from _cuda_emu import card_paths, emulated_libs  # noqa: F401


@pytest.mark.parametrize("storage", ["compressed", "journaled"])
def test_captured_segments_equal_the_uncaptured_ones(card_paths, monkeypatch,
                                                     tmp_path, storage):
    """The front door's fused gradient with captured segments over
    ``storage`` is bit for bit the uncaptured run's
    (``_captured_cases.check_captured_equal``)."""
    check_captured_equal(monkeypatch, tmp_path, storage)

"""Captured fused segments (``segment_fused.CapturedRun``) run on the CPU
under the emulation of ``tests/_cuda_emu.py``, where each graph replay runs
its launches again: through the front door bit for bit the uncaptured
segments over RAM and the tiered store, with the same counters and
launches, a second call reusing the graphs and the pooled page-locked
slots (the compressed and journaled stores in
``test_torch_cuda_emulated_captured_stores.py``; a crash resumed and the
argument block in ``..._captured_resume.py``; new parameters and
``clear_caches`` in ``..._captured_params.py``).
"""
import pytest
from _captured_cases import check_captured_equal
from _cuda_emu import card_paths, emulated_libs  # noqa: F401


@pytest.mark.parametrize("storage", ["ram", "tiered"])
def test_captured_segments_equal_the_uncaptured_ones(card_paths, monkeypatch,
                                                     tmp_path, storage):
    """The front door's fused gradient with captured segments over
    ``storage`` is bit for bit the uncaptured run's
    (``_captured_cases.check_captured_equal``)."""
    check_captured_equal(monkeypatch, tmp_path, storage)

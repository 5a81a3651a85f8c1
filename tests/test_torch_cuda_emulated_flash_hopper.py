"""The attention forward's Hopper form (``csrc/flash_attention.cu``:
``flash_fwd_wgmma_kernel``, a TMA-fed ring, wgmma consumer warpgroups, the
output stored by TMA) under the emulation of ``tests/_cuda_emu.py``,
against the plain version ``flash_attention_plain`` and the plain chunked
forward's logsumexp: D=64 over several query and kv tiles with GQA, the
window and the softcap, Sq < Sk non-causal with a ragged edge, D=128 with
rows that see no key (Sq > Sk), and gemma2-2b's D=256.  Two calls give
the same bits.  bf16 at D >= 64 never takes the ``mma.sync`` form; D=32
does and counts apart.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import _np, bits_equal, emulated_libs, kernels_on_card  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _chunked_fwd


def _check(B, Sq, Sk, H, G, D, kw):
    """out within 3e-2 of the plain version per element (rows that see no
    key exactly 0), lse within 1e-5, one launch, two calls bit for bit;
    returns the ``mma_sync`` count the two calls added."""
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.tensor(_np(rng, shape)).to(torch.bfloat16)
               for shape in ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    before = (fa.flash_attention.launches, fa.flash_attention.mma_sync)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    assert fa.flash_attention.launches == before[0] + 1
    causal = kw.get("causal", True)
    want = fa.flash_attention_plain(q, k, v, **kw)
    _, want_lse = _chunked_fwd(q, k, v, causal, kw.get("window"),
                               kw.get("softcap"), 16, kw.get("scale"))
    unseen = max(Sq - Sk, 0) if causal else 0
    assert not bool(out[:, :unseen].float().abs().gt(0).any())
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out[:, unseen:].float(),
                               want[:, unseen:].float(), rtol=3e-2,
                               atol=3e-2)
    torch.testing.assert_close(lse[..., unseen:], want_lse[..., unseen:],
                               rtol=1e-5, atol=1e-5)
    again = fa.flash_attention_fwd(q, k, v, **kw)
    assert bits_equal(out, again[0]) and bits_equal(lse, again[1])
    return fa.flash_attention.mma_sync - before[1]


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,kw", [
    # three query tiles of 128 (the last ragged), three kv tiles, GQA
    (1, 300, 300, 4, 2, 64, {"window": 100, "softcap": 30.0}),
    # Sq < Sk non-causal, a ragged last kv tile, two batch rows
    (2, 70, 200, 2, 2, 64, {"causal": False, "scale": 0.2}),
    # Sq > Sk causal: the first 60 rows see no key
    (1, 190, 130, 2, 1, 128, {"softcap": 20.0}),
    # gemma2-2b's head dim: 64-key tiles, its softcap and scale
    (1, 150, 150, 2, 1, 256, {"softcap": 50.0, "scale": 0.0625}),
])
def test_hopper_form(kernels_on_card, B, Sq, Sk, H, G, D, kw):
    assert _check(B, Sq, Sk, H, G, D, kw) == 0


def test_head_dim_32_takes_the_mma_sync_form(kernels_on_card):
    assert _check(1, 70, 70, 2, 1, 32, {"window": 20}) == 2   # two calls

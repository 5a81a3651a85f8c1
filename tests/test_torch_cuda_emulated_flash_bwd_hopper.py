"""The attention backward's Hopper form (``csrc/flash_attention_bwd.cu``:
``bwd_dq_wgmma_kernel`` and ``bwd_dkdv_wgmma_kernel``, a TMA-fed ring and
wgmma consumer warpgroups) under the emulation of ``tests/_cuda_emu.py``,
against the plain version as in ``test_torch_cuda_emulated_flash_bwd.py``:
D=64 (half a 128-byte row a consumer's dK/dV columns) over several query
and kv tiles with GQA, the window and the softcap, Sq < Sk non-causal, and
a D=128 case; gemma2-2b's D=256 is in ``..._flash_bwd_d256.py``.  bf16 at
D >= 64 never takes the ``mma.sync`` form; D=32 does and counts apart.
"""
import pytest
import torch
from _cuda_emu import emulated_libs, kernels_on_card  # noqa: F401
from _flash_bwd_cases import check_flash_bwd_case

from repro_torch.kernels import flash_attention as fa


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,kw", [
    (1, 150, 150, 4, 2, 64, {"window": 50, "softcap": 30.0}),
    (2, 40, 90, 2, 2, 64, {"causal": False, "scale": 0.2}),
    (1, 140, 140, 2, 1, 128, {"softcap": 20.0}),
])
def test_hopper_form(kernels_on_card, B, Sq, Sk, H, G, D, kw):
    before = fa.flash_attention_bwd.mma_sync
    check_flash_bwd_case(B, Sq, Sk, H, G, D, torch.bfloat16, kw)
    assert fa.flash_attention_bwd.mma_sync == before


def test_head_dim_32_takes_the_mma_sync_form(kernels_on_card):
    before = fa.flash_attention_bwd.mma_sync
    check_flash_bwd_case(1, 20, 20, 2, 1, 32, torch.bfloat16, {})
    assert fa.flash_attention_bwd.mma_sync == before + 2   # two calls

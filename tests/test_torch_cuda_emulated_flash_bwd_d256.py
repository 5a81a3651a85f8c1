"""The flash-attention backward CUDA source under the emulation of
``tests/_cuda_emu.py`` at gemma2-2b's head dim (D=256: 32-key tiles,
ragged edges, softcap, window, GQA, both launches over several tiles),
against its plain version as in ``test_torch_cuda_emulated_flash_bwd.py``
(split off: it is the slowest case, so the workers run it beside the
others).
"""
import pytest
import torch
from _cuda_emu import emulated_libs, kernels_on_card  # noqa: F401
from _flash_bwd_cases import check_flash_bwd_case


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,dtype,kw", [
    (1, 70, 70, 4, 2, 256, torch.bfloat16, {"softcap": 50.0, "window": 40,
                                            "scale": 0.0625}),
])
def test_flash_attention_bwd_kernel_source(kernels_on_card, B, Sq, Sk, H,
                                           G, D, dtype, kw):
    check_flash_bwd_case(B, Sq, Sk, H, G, D, dtype, kw)

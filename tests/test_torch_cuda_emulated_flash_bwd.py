"""The flash-attention backward CUDA source (``csrc/flash_attention_bwd.cu``)
run on the CPU under the emulation of ``tests/_cuda_emu.py`` (its
tensor-core instructions as warp-collective host versions with the PTX
fragment layout) through its wrapper's card path, against its plain
version ``models/attention.py::_chunked_bwd`` on the same forward's ``out``
and ``lse``: dq, dk and dv each within 2e-4 (fp32) or 3e-2 (bf16) of the
plain version's max |value|, two calls bit for bit
(``_flash_bwd_cases.check_flash_bwd_case``; gemma2-2b's head dim in
``test_torch_cuda_emulated_flash_bwd_d256.py``), a refused head dim
raising ``ValueError``.
"""
import pytest
import torch
from _cuda_emu import emulated_libs, kernels_on_card  # noqa: F401
from _flash_bwd_cases import _case, check_flash_bwd_case

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _chunked_fwd


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,dtype,kw", [
    # two query tiles with a ragged edge, a ragged last kv tile, fp32
    (1, 70, 70, 2, 1, 16, torch.float32, {}),
    # Sq < Sk, GQA (2 query heads a kv head), sliding window and softcap
    (1, 40, 75, 4, 2, 64, torch.bfloat16, {"window": 20, "softcap": 30.0}),
    # D=16 (the SMOKE configs' head dim), GQA, window and softcap; fp32
    # non-causal with a head dim that leaves lanes idle
    (2, 33, 33, 4, 2, 16, torch.bfloat16, {"window": 8, "softcap": 50.0}),
    (1, 33, 50, 2, 2, 40, torch.float32, {"causal": False, "scale": 0.3,
                                          "softcap": 20.0}),
])
def test_flash_attention_bwd_kernel_source(kernels_on_card, B, Sq, Sk, H,
                                           G, D, dtype, kw):
    check_flash_bwd_case(B, Sq, Sk, H, G, D, dtype, kw)


def test_flash_attention_bwd_refuses_other_head_dims(kernels_on_card):
    """The bf16 kernel takes D in {16, 32, 64, 128, 256}, fp32 any D up to
    256: anything else is refused by the wrapper, never routed elsewhere."""
    q, k, v, dout = _case(1, 8, 8, 2, 1, 48, torch.bfloat16, 0)
    out = _chunked_fwd(q, k, v, True, None, None, 8, None)[0].contiguous()
    lse = _chunked_fwd(q, k, v, True, None, None, 8, None)[1]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout)
    q, k, v, dout = _case(1, 8, 8, 2, 1, 272, torch.float32, 0)
    out = _chunked_fwd(q, k, v, True, None, None, 8, None)[0].contiguous()
    lse = _chunked_fwd(q, k, v, True, None, None, 8, None)[1]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout)

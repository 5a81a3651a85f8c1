"""The flash-attention backward CUDA source (``csrc/flash_attention_bwd.cu``)
run on the CPU under the emulation of ``tests/_cuda_emu.py`` (its
tensor-core instructions as warp-collective host versions with the PTX
fragment layout) through its wrapper's card path, against its plain
version ``models/attention.py::_chunked_bwd`` on the same forward's ``out``
and ``lse``: dq, dk and dv each within 2e-4 (fp32) or 3e-2 (bf16) of the
plain version's max |value|, two calls bit for bit, a refused head dim
raising ``ValueError``.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _chunked_bwd, _chunked_fwd


def _case(B, Sq, Sk, H, G, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.tensor(_np(rng, shape)).to(dtype) for shape in (
        (B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D), (B, Sq, H, D)))
    return q, k, v, dout


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,dtype,kw", [
    # two query tiles with a ragged edge, a ragged last kv tile, fp32
    (1, 70, 70, 2, 1, 16, torch.float32, {}),
    # Sq < Sk, GQA (2 query heads a kv head), sliding window and softcap
    (1, 40, 75, 4, 2, 64, torch.bfloat16, {"window": 20, "softcap": 30.0}),
    # gemma2-2b's head dim: 32-key tiles, ragged edges, softcap, window,
    # GQA, both launches over several tiles
    (1, 70, 70, 4, 2, 256, torch.bfloat16, {"softcap": 50.0, "window": 40,
                                            "scale": 0.0625}),
    # D=16 (the SMOKE configs' head dim), GQA, window and softcap; fp32
    # non-causal with a head dim that leaves lanes idle
    (2, 33, 33, 4, 2, 16, torch.bfloat16, {"window": 8, "softcap": 50.0}),
    (1, 33, 50, 2, 2, 40, torch.float32, {"causal": False, "scale": 0.3,
                                          "softcap": 20.0}),
])
def test_flash_attention_bwd_kernel_source(kernels_on_card, B, Sq, Sk, H,
                                           G, D, dtype, kw):
    q, k, v, dout = _case(B, Sq, Sk, H, G, D, dtype, Sq + D)
    args = (kw.get("causal", True), kw.get("window"), kw.get("softcap"))
    out, lse = _chunked_fwd(q, k, v, *args, 16, kw.get("scale"))
    out = out.contiguous()   # the layout of the forward kernel's output
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert fa.flash_attention_bwd.launches == before + 1
    want = _chunked_bwd(*args, 16, kw.get("scale"), (q, k, v, out, lse),
                        dout)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert scaled_err(a, b) <= tol, (name, scaled_err(a, b))
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(bits_equal(a, b) for a, b in zip(got, again))


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

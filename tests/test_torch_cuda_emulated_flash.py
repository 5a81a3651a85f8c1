"""The flash-attention CUDA source (``csrc/flash_attention.cu``) run on the
CPU under the emulation of ``tests/_cuda_emu.py`` (its tensor-core
instructions as warp-collective host versions with the PTX fragment
layout), against its plain version.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import _np, card_paths, emulated_libs  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _chunked_fwd

@pytest.mark.parametrize("B,Sq,Sk,H,G,D,dtype,kw", [
    # two query tiles with a ragged edge, a ragged last kv tile
    (1, 70, 70, 2, 1, 16, torch.float32, {}),
    # Sq < Sk, GQA, sliding window and softcap, bf16
    (1, 40, 75, 4, 2, 64, torch.bfloat16, {"window": 20, "softcap": 30.0}),
    # non-causal, a head dim that leaves lanes idle, two batch rows
    (2, 33, 33, 2, 2, 40, torch.float32, {"causal": False, "scale": 0.3}),
    # the tensor-core kernel at D=256 (32-key tiles): two query tiles, a
    # ragged query and kv edge, softcap
    (1, 70, 70, 2, 1, 256, torch.bfloat16, {"softcap": 50.0,
                                            "scale": 0.0625}),
    # D=128, Sq > Sk: rows that see no key give 0; non-causal GQA
    (1, 80, 50, 2, 1, 128, torch.bfloat16, {}),
    (1, 20, 150, 4, 1, 128, torch.bfloat16, {"causal": False}),
    # D=16 (gemma2-2b SMOKE's head dim): window and softcap, GQA; D=32
    (1, 70, 70, 4, 2, 16, torch.bfloat16, {"window": 8, "softcap": 50.0,
                                           "scale": 0.25}),
    (2, 33, 40, 2, 1, 32, torch.bfloat16, {"causal": False}),
])
def test_flash_attention_kernel_source(card_paths, B, Sq, Sk, H, G, D,
                                       dtype, kw):
    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.tensor(_np(rng, shape)).to(dtype) for shape in (
        (B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    before = fa.flash_attention.launches
    out, lse = fa._launch(q, k, v, kw.get("causal", True), kw.get("window"),
                          kw.get("softcap"), kw.get("scale"))
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention(q, k, v, **kw)   # the plain version (CPU)
    _, want_lse = _chunked_fwd(q, k, v, kw.get("causal", True),
                               kw.get("window"), kw.get("softcap"), 16,
                               kw.get("scale"))
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    seen = Sq - max(Sq - Sk, 0) if kw.get("causal", True) else Sq
    unseen = Sq - seen   # rows before the first key: 0 from the kernel
    assert not bool(out[:, :unseen].float().abs().gt(0).any())
    torch.testing.assert_close(out[:, unseen:].float(),
                               want[:, unseen:].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse[..., unseen:], want_lse[..., unseen:],
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_bf16_rejects_other_head_dims(card_paths):
    """The tensor-core kernel takes D in {16, 32, 64, 128, 256}; any other
    bf16 head dim is refused by the C entry point (and by the wrapper on the
    card), never routed elsewhere."""
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa._launch(q, k, k, True, None, None, None)

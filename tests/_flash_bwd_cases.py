"""The cases the flash-attention backward's emulated-kernel files share
(``test_torch_cuda_emulated_flash_bwd*.py``: gemma2-2b's head dim, the
slowest case, in a file of its own so the workers run it beside the
others): the inputs, and the check of one case through the wrapper's card
path against the plain version ``models/attention.py::_chunked_bwd``."""
import numpy as np
import torch
from _cuda_emu import _np, bits_equal, scaled_err

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import _chunked_bwd, _chunked_fwd


def _case(B, Sq, Sk, H, G, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.tensor(_np(rng, shape)).to(dtype) for shape in (
        (B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D), (B, Sq, H, D)))
    return q, k, v, dout


def check_flash_bwd_case(B, Sq, Sk, H, G, D, dtype, kw):
    """dq, dk and dv within 2e-4 (fp32) or 3e-2 (bf16) of the plain
    version's max |value| on the same forward's ``out`` and ``lse``, one
    launch counted, two calls bit for bit."""
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

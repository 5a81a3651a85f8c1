# Port of repro/distributed/compression.py: quantize_np, dequantize_np and
# a numpy quantization_error_bound (the host codec of the compressed Level-2
# backend).
"""int8 absmax quantisation on the host.

Each array becomes an int8 payload and one f32 scale (``absmax / 127``);
decoding multiplies back.  The round-trip error per element is at most
``scale / 2 = absmax / 254`` (:func:`quantization_error_bound`).  The codec
is plain numpy: the Level-2 writer and prefetch threads that run it must
stay off the card they overlap with.  The cross-pod ``compressed_mean``
comes with sharded offloading (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_np(x) -> Tuple[np.ndarray, np.float32]:
    """``(q, scale)``: ``q = clip(round(x / scale), -127, 127)`` as int8,
    ``scale = max(absmax, 1e-30) / 127`` as f32 (an all-zero array gets
    the floor scale and an all-zero payload)."""
    x32 = np.asarray(x, dtype=np.float32)
    amax = float(np.max(np.abs(x32))) if x32.size else 0.0
    scale = np.float32(max(amax, 1e-30) / 127.0)
    q = np.clip(np.round(x32 / scale), -127, 127)
    return q.astype(np.int8), scale


def dequantize_np(q, scale) -> np.ndarray:
    return np.asarray(q, dtype=np.float32) * np.float32(scale)


def quantization_error_bound(x) -> float:
    """``|x - dq(q(x))|_inf <= absmax / 254``."""
    return float(np.max(np.abs(np.asarray(x, dtype=np.float32))) / 254.0
                 + 1e-12)

"""Parameters carried across packages.

``params_from_numpy`` takes a parameter tree of numpy arrays — for the JAX
package's parameters, ``jax.tree_util.tree_map(np.asarray, params)`` — and
returns the port's dict with the same keys, shapes and layout: the LSTM's
``w`` stays ``(Dx+Dh, 4Dh)``, gate-major ``i, f, o, g``; a decoder's
``init_lm`` tree keeps ``params["layers"]["pos{j}"]`` stacked over periods
(leading axis ``n_periods``), dense weights ``(d_in, d_out)`` and norm scales
stored as ``scale - 1``.  ``params_to_numpy`` is its inverse.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.device import resolve_device


def params_from_numpy(tree: Any, *, device=None) -> Any:
    """numpy tree -> tensor tree on ``device`` (the card unless
    ``device="cpu"``), copying each leaf."""
    dev = resolve_device(device)
    return pytree.tree_map(
        lambda a: torch.tensor(np.array(a, copy=True), device=dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """tensor tree -> numpy tree (host copies)."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def init_lstm_numpy(seed: int, vocab: int, d_embed: int,
                    d_hidden: int) -> Dict[str, np.ndarray]:
    """LSTM parameters drawn from ``numpy.random.default_rng(seed)`` with
    the distributions of ``init_lstm`` (both packages' ``init_lstm`` draw
    from their own generators; numpy weights feed both identically)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(f32)

    return {
        "emb": normal((vocab, d_embed), 0.1),
        "w": normal((d_embed + d_hidden, 4 * d_hidden),
                    (d_embed + d_hidden) ** -0.5),
        "b": np.zeros((4 * d_hidden,), f32),
        "w_out": normal((d_hidden, vocab), d_hidden ** -0.5),
        "b_out": np.zeros((vocab,), f32),
    }

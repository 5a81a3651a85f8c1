# Port of repro/models/model_factory.py: the lstm, dense and ssm branches.
"""Uniform model API.

``get_model(cfg)`` returns a ``ModelAPI`` with

    init(generator, device=None)   -> params
    train_loss(params, batch)      -> scalar loss (tagged with chain_spec)

for the paper's LSTM and the dense and SSM decoder families.  Serving entry
points (``prefill``/``decode``/``init_cache``) raise ``NotImplementedError``
for the decoders (ROADMAP queue 1, item 14); the MoE, hybrid, VLM and
encoder-decoder families come later (item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lstm, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    # ChainSpec decomposition of train_loss for the offloaded autodiff
    train_chain: Any = None


def _attach_chain(loss_fn: Callable, chain_spec) -> Callable:
    """Tag a loss callable with its chain decomposition so
    ``value_and_grad_offloaded(api.train_loss)`` just works."""
    if chain_spec is not None:
        loss_fn.chain_spec = chain_spec
    return loss_fn


def _not_ported(what: str) -> Callable:
    def raise_(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP queue 1, item 14)")

    return raise_


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.family in ("dense", "ssm"):
        chain = transformer.train_chain(cfg)
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: transformer.init_lm(
                generator, cfg, device=device),
            train_loss=_attach_chain(
                lambda p, b: transformer.train_loss(p, b, cfg), chain),
            prefill=_not_ported("prefill"),
            decode=_not_ported("decode"),
            init_cache=_not_ported("init_cache"),
            train_chain=chain,
        )
    if cfg.family == "lstm":
        def _loss(p, b):
            return lstm.forward_loss(p, b["tokens"])

        chain = lstm.train_chain(cfg)
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: lstm.init_lstm(
                generator, cfg.vocab, cfg.d_model, cfg.d_ff, device=device),
            train_loss=_attach_chain(_loss, chain),
            train_chain=chain,
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
        "item 10)")

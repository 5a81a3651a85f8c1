"""A MoE layer's routing and data movement (``csrc/moe.cu``): top-k softmax
routing, the capacity slots of the one-hot dispatch, the gather of the kept
rows into expert-major buckets and the weighted combine, each with its vjp
where it has one.

Replaces the arithmetic of ``repro/models/moe.py::_route`` (:81-97), the
slot assignment and dispatch einsum of ``::moe_einsum`` (:129-149) and its
combine einsum (:151), with their vjps, inside the TPU kernels
``repro/kernels/segment_pallas.py``'s segments (a MoE decoder body traced
into the ``pallas_call``).  The one-hot products become what they compute:
a dispatch copies each kept row into its slot, a combine sums a token's k
slots weighted; the slots keep the einsum's positions (choice ``i`` of
every token after every token's choices before ``i``, dropped at
capacity ``C``, an empty slot a zero row).  The buckets lie expert-major,
``(E, G C, d)``: expert ``e``'s rows are one matrix for the batched expert
GEMM (``kernels/dense.py::project_experts``).

Layouts: ``choice_slot`` (G, S, k) int32 is each choice's flat bucket row
(``e G C + g C + position``), -1 where dropped; ``slot_src`` (E, G C)
int32 is the choice that fills each bucket row (``(g S + s) k + i``), -1
where empty; ``routed`` (G, E) int32 the routed count by group and expert
(each group keeps ``min(routed, C)``).

The model-facing functions :func:`route`, :func:`slots`, :func:`dispatch`
and :func:`combine` launch the kernels for CUDA tensors (autograd functions
whose backwards launch the backward kernels, or raise) and run the plain
versions (``*_plain``, PyTorch gathers; the vjps by autograd) elsewhere.
The routing kernels also compute the Switch aux loss (:func:`aux_plain`)
and add it to a running total, and take its cotangent in the backward; the
dispatch gives one output for each reader of the buckets (the experts'
gate and up products), whose cotangents its backward kernel sums; the
combine adds the layer's residual in its kernel.
``models/moe.py`` calls them only on the card: on the CPU its one-hot
einsums run as before, and the plain versions here are what the kernels
are held against.  Each wrapper counts its launches (``.launches``; a
backward of one or more kernel launches a call counts once).  Limits:
``E`` <= 64 experts, ``k`` <= min(E, 8) choices (``ValueError``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)
MAX_E, MAX_K = 64, 8
# the route backward's dW_r: partial sums over this many fixed row ranges
# at most, each of at least ROWS_PER_SPLIT rows (a function of N alone)
MAX_SPLITS, ROWS_PER_SPLIT = 16, 512


def _lib():
    lib = build.load("moe")
    lib.moe_route_fwd.restype = _I
    lib.moe_route_fwd.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.moe_route_blocks.restype = _I
    lib.moe_route_blocks.argtypes = [_I]
    lib.moe_route_bwd.restype = _I
    lib.moe_route_bwd.argtypes = [_P] * 11 + [_I] * 6 + [_P]
    lib.moe_slots.restype = _I
    lib.moe_slots.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.moe_dispatch.restype = _I
    lib.moe_dispatch.argtypes = [_P] * 3 + [_L, _I, _I, _I, _P]
    lib.moe_dispatch_bwd.restype = _I
    lib.moe_dispatch_bwd.argtypes = [_P] * 4 + [_L, _I, _I, _I, _P]
    lib.moe_combine.restype = _I
    lib.moe_combine.argtypes = [_P] * 5 + [_L, _I, _I, _I, _I, _P]
    lib.moe_combine_bwd.restype = _I
    lib.moe_combine_bwd.argtypes = [_P] * 7 + [_L, _L, _I, _I, _I, _I, _P]
    return lib


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def _check_ek(what, E: int, k: int) -> None:
    if not 1 <= E <= MAX_E:
        raise ValueError(f"{what}: {E} experts, the kernels take 1 to "
                         f"{MAX_E}")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"{what}: top-{k} of {E} experts, the kernels take "
                         f"1 to {min(E, MAX_K)} choices")


def _check_dtype(what, named) -> None:
    for name, t in named:
        if t.dtype not in DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype}, not one of "
                             f"{list(DTYPES)}")


def _check_slots(what, choice_slot, slot_src) -> None:
    for name, t in (("choice_slot", choice_slot), ("slot_src", slot_src)):
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} is {t.dtype}, not int32")
    if choice_slot.dim() != 3 or slot_src.dim() != 2:
        raise ValueError(f"{what}: choice_slot{tuple(choice_slot.shape)} "
                         f"must be (G, S, k), slot_src"
                         f"{tuple(slot_src.shape)} (E, G C)")


# ------------------------------------------------------------- routing


def route_plain(x: torch.Tensor, w: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(weights (G, S, k), idx (G, S, k) int64, probs (G, S, E))``: the
    fp32 logits ``x W_r``, their softmax, its top ``top_k`` by a stable
    descending sort (the lower expert first among equals, as
    ``lax.top_k``) and those renormalised (``repro/models/moe.py::_route``
    without its aux loss)."""
    logits = torch.einsum("gsd,de->gse", x.float(), w.float())
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = srt[..., :top_k], order[..., :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx, probs


def aux_plain(probs: torch.Tensor, idx: torch.Tensor, n_experts: int
              ) -> torch.Tensor:
    """The Switch load-balance loss ``E sum_e me_e ce_e`` of one routing
    (``repro/models/moe.py::_route``'s ``aux``): ``me`` the mean
    probability, ``ce`` the mean count of choices, of each expert."""
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, n_experts).float().sum(2).mean(dim=(0, 1))
    return n_experts * torch.sum(me * ce)


def route_bwd_plain(dweights: Optional[torch.Tensor],
                    daux: Optional[torch.Tensor], x: torch.Tensor,
                    w: torch.Tensor, top_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)``: the vjp of :func:`route_plain`'s ``weights`` and of the
    aux loss :func:`aux_plain` for their cotangents (None for zeros), by
    autograd over them recomputed; dx in x's dtype, dw in fp32."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = w.detach().float().requires_grad_(True)
        weights, idx, probs = route_plain(xr, wr, top_k)
        aux = aux_plain(probs, idx, w.shape[1])
        outs, cots = [], []
        for out, cot in ((weights, dweights), (aux, daux)):
            if cot is not None:
                outs.append(out)
                cots.append(cot)
        return torch.autograd.grad(outs, (xr, wr), cots)


def _check_route(what, x, w, top_k) -> None:
    _check_dtype(what, [("x", x)])
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"{what}: x{tuple(x.shape)} must be (G, S, d) and "
                         f"w{tuple(w.shape)} (d, E)")
    if w.dtype != torch.float32 or w.device != x.device:
        raise ValueError(f"{what}: w is {w.dtype} on {w.device}, fp32 on "
                         f"{x.device} expected")
    _check_ek(what, w.shape[1], top_k)


def moe_route(x: torch.Tensor, w: torch.Tensor, top_k: int, *,
              aux_in: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """The routing kernels (CUDA tensors only): :func:`route_plain`'s
    ``(weights, idx, probs)``, then ``aux_in`` (a 0-d fp32 running total,
    None for 0) plus :func:`aux_plain`'s loss, and each expert's mean
    count of choices ``ce`` (E,) fp32 for the backward: ``(weights, idx,
    probs, aux, ce)``.  x (G, S, d) fp32 or bf16, w (d, E) fp32."""
    if not build.on_card(x):
        raise ValueError("moe_route runs on the card only")
    _check_route("moe_route", x, w, top_k)
    if aux_in is not None and (aux_in.shape != () or aux_in.dtype
                               != torch.float32 or aux_in.device != x.device):
        raise ValueError(f"moe_route: aux_in{tuple(aux_in.shape)} "
                         f"{aux_in.dtype} must be a 0-d fp32 tensor on "
                         f"{x.device}")
    G, S, d = x.shape
    E = w.shape[1]
    x, w = build.dense(x, "moe_route: x"), build.dense(w, "moe_route: w")
    dev = x.device
    probs = torch.empty((G, S, E), dtype=torch.float32, device=dev)
    weights = torch.empty((G, S, top_k), dtype=torch.float32, device=dev)
    idx = torch.empty((G, S, top_k), dtype=torch.int64, device=dev)
    aux = torch.empty((), dtype=torch.float32, device=dev)
    ce = torch.empty((E,), dtype=torch.float32, device=dev)
    lib = _lib()
    # the routing blocks' partial sums of the aux loss
    nb = lib.moe_route_blocks(G * S)
    part_p = torch.empty((nb, E), dtype=torch.float32, device=dev)
    part_c = torch.empty((nb, E), dtype=torch.int32, device=dev)
    err = lib.moe_route_fwd(build.ptr(x), build.ptr(w), build.ptr(probs),
                            build.ptr(weights), build.ptr(idx),
                            build.ptr(aux_in), build.ptr(aux), build.ptr(ce),
                            build.ptr(part_p), build.ptr(part_c), G * S, d,
                            E, top_k, _bf16(x), build.stream_ptr(dev))
    build.check(lib, err, "moe_route")
    moe_route.launches += 1
    return weights, idx, probs, aux, ce


def route_splits(n_tokens: int) -> int:
    """The fixed row ranges of the route backward's dW_r partial sums."""
    return min(MAX_SPLITS, max(1, -(-n_tokens // ROWS_PER_SPLIT)))


def moe_route_bwd(dweights: Optional[torch.Tensor],
                  daux: Optional[torch.Tensor], x: torch.Tensor,
                  w: torch.Tensor, probs: torch.Tensor, idx: torch.Tensor,
                  ce: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing backward (CUDA tensors only): ``(dx, dw)`` for the
    cotangents of :func:`moe_route`'s weights (G, S, k) and aux (0-d), fp32
    (None for zeros), from its saved ``probs``, ``idx`` and ``ce``."""
    if not build.on_card(x):
        raise ValueError("moe_route_bwd runs on the card only")
    top_k = idx.shape[-1]
    _check_route("moe_route_bwd", x, w, top_k)
    G, S, d = x.shape
    E, N = w.shape[1], G * S
    for name, t, shape in (("dweights", dweights, (G, S, top_k)),
                           ("daux", daux, ()), ("ce", ce, (E,)),
                           ("probs", probs, (G, S, E))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"moe_route_bwd: {name}{tuple(t.shape)} "
                             f"{t.dtype} must be contiguous fp32 {shape}")
    x, w = build.dense(x, "moe_route_bwd: x"), build.dense(w, "w")
    idx = build.dense(idx, "moe_route_bwd: idx")
    nsplit = route_splits(N)
    dlog = torch.empty((N, E), dtype=torch.float32, device=x.device)
    part = torch.empty((nsplit, d, E), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty((d, E), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.moe_route_bwd(build.ptr(x), build.ptr(w), build.ptr(probs),
                            build.ptr(idx), build.ptr(dweights),
                            build.ptr(daux), build.ptr(ce), build.ptr(dlog),
                            build.ptr(part), build.ptr(dx), build.ptr(dw), N,
                            d, E, top_k, nsplit, _bf16(x),
                            build.stream_ptr(x.device))
    build.check(lib, err, "moe_route_bwd")
    moe_route_bwd.launches += 1
    return dx, dw


class _Route(torch.autograd.Function):
    """The routing kernels as one autograd function (CUDA tensors): saves
    x, w and the forward's probs, choices and ``ce``; the running total's
    cotangent is the aux's."""

    @staticmethod
    def forward(ctx, x, w, top_k, aux_in):
        weights, idx, probs, aux, ce = moe_route(x, w, top_k, aux_in=aux_in)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(x, w, probs, idx, ce)
        ctx.set_materialize_grads(False)
        return weights, idx, aux

    @staticmethod
    def backward(ctx, dweights, _didx, daux):
        x, w, probs, idx, ce = ctx.saved_tensors
        dx, dw = moe_route_bwd(build.cotangent(dweights), daux, x, w, probs,
                               idx, ce)
        return dx, dw, None, (daux if ctx.needs_input_grad[3] else None)


def route(x: torch.Tensor, w: torch.Tensor, top_k: int,
          aux_in: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(weights, idx, aux)``: :func:`route_plain`'s weights and choices
    and :func:`aux_plain`'s loss, added to ``aux_in`` (a running total)
    where given; differentiable in x, w and ``aux_in``: the kernels on the
    card (the sum in the kernel), the plain version elsewhere."""
    if build.on_card(x):
        return _Route.apply(x, w.float(), top_k, aux_in)
    weights, idx, probs = route_plain(x, w, top_k)
    aux = aux_plain(probs, idx, w.shape[1])
    return weights, idx, (aux if aux_in is None else aux_in + aux)


# --------------------------------------------------------------- slots


def slots_plain(idx: torch.Tensor, E: int, C: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(choice_slot, slot_src, routed)`` (the module's layouts) of the
    choices ``idx`` (G, S, k): each choice's position by expert in
    choice-major order (every token's choice ``i`` after every token's
    choices before ``i``), kept below ``C`` -- the one-hot dispatch's
    ``cumsum`` with its ``prior``."""
    G, S, k = idx.shape
    dev = idx.device
    flat_e = idx.transpose(1, 2).reshape(G, k * S)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, 1, dtype=torch.int32), 2,
                       flat_e[..., None])[..., 0] - 1
    routed = onehot.sum(1, dtype=torch.int32)
    keep = pos < C
    g = torch.arange(G, device=dev)
    slot = flat_e * (G * C) + g[:, None] * C + pos
    choice_slot = torch.where(keep, slot, -1).reshape(G, k, S)
    choice_slot = choice_slot.transpose(1, 2).to(torch.int32).contiguous()
    src = ((g[:, None, None] * S + torch.arange(S, device=dev)) * k
           + torch.arange(k, device=dev)[:, None]).reshape(G, k * S)
    slot_src = torch.full((E * G * C,), -1, dtype=torch.int32, device=dev)
    slot_src[slot[keep]] = src[keep].to(torch.int32)
    return choice_slot, slot_src.reshape(E, G * C), routed


def moe_slots(idx: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slots kernel (CUDA tensors only): :func:`slots_plain`."""
    if not build.on_card(idx):
        raise ValueError("moe_slots runs on the card only")
    if idx.dim() != 3 or idx.dtype != torch.int64:
        raise ValueError(f"moe_slots: idx{tuple(idx.shape)} {idx.dtype} "
                         "must be (G, S, k) int64")
    G, S, k = idx.shape
    _check_ek("moe_slots", E, k)
    if E * G * C >= 2 ** 31 or G * S * k >= 2 ** 31:
        raise ValueError(f"moe_slots: E G C = {E * G * C} bucket rows, G S k "
                         f"= {G * S * k} choices: at most 2**31 - 1")
    idx = build.dense(idx, "moe_slots: idx")
    dev = idx.device
    choice_slot = torch.empty((G, S, k), dtype=torch.int32, device=dev)
    slot_src = torch.empty((E, G * C), dtype=torch.int32, device=dev)
    routed = torch.empty((G, E), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.moe_slots(build.ptr(idx), build.ptr(choice_slot),
                        build.ptr(slot_src), build.ptr(routed), G, S, k, E, C,
                        build.stream_ptr(dev))
    build.check(lib, err, "moe_slots")
    moe_slots.launches += 1
    return choice_slot, slot_src, routed


def slots(idx: torch.Tensor, E: int, C: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`slots_plain`: the kernel on the card."""
    if build.on_card(idx):
        return moe_slots(idx, E, C)
    return slots_plain(idx, E, C)


# ------------------------------------------------------------ dispatch


def _padded(rows: torch.Tensor, d: int) -> torch.Tensor:
    """``rows`` as (n, d) with a zero row appended (row n)."""
    rows = rows.reshape(-1, d)
    return torch.cat([rows, rows.new_zeros((1, d))])


def _choice_rows(choice_slot: torch.Tensor, n: int) -> torch.Tensor:
    """Each choice's bucket row, ``n`` (a padded zero row) where dropped."""
    return torch.where(choice_slot >= 0, choice_slot, n).long()


def dispatch_plain(x: torch.Tensor, slot_src: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The buckets (E, G C, d): each row x's row of the choice that fills
    it, zeros where empty."""
    G, S, d = x.shape
    tok = torch.where(slot_src >= 0, slot_src // k, G * S).long()
    return _padded(x, d)[tok]


def dispatch_bwd_plain(dexp: torch.Tensor, choice_slot: torch.Tensor
                       ) -> torch.Tensor:
    """dx (G, S, d): each token's kept choices' rows of ``dexp`` summed in
    fp32 in choice order, rounded once to dexp's dtype."""
    G, S, k = choice_slot.shape
    d = dexp.shape[-1]
    rows = _padded(dexp, d)
    sl = _choice_rows(choice_slot, rows.shape[0] - 1)
    acc = torch.zeros((G, S, d), dtype=torch.float32, device=dexp.device)
    for i in range(k):
        acc = acc + rows[sl[..., i]].float()
    return acc.to(dexp.dtype)


def moe_dispatch(x: torch.Tensor, slot_src: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """The dispatch kernel (CUDA tensors only): :func:`dispatch_plain`."""
    if not build.on_card(x):
        raise ValueError("moe_dispatch runs on the card only")
    _check_dtype("moe_dispatch", [("x", x)])
    if x.dim() != 3 or slot_src.dim() != 2 or slot_src.dtype != torch.int32:
        raise ValueError(f"moe_dispatch: x{tuple(x.shape)} must be (G, S, "
                         f"d), slot_src{tuple(slot_src.shape)} (E, G C) "
                         "int32")
    d = x.shape[2]
    x = build.dense(x, "moe_dispatch: x")
    slot_src = build.dense(slot_src, "moe_dispatch: slot_src")
    out = torch.empty((*slot_src.shape, d), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.moe_dispatch(build.ptr(x), build.ptr(slot_src), build.ptr(out),
                           slot_src.numel(), d, k, _bf16(x),
                           build.stream_ptr(x.device))
    build.check(lib, err, "moe_dispatch")
    moe_dispatch.launches += 1
    return out


def moe_dispatch_bwd(dexp: torch.Tensor, choice_slot: torch.Tensor,
                     dexp2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dispatch's backward kernel (CUDA tensors only):
    :func:`dispatch_bwd_plain` of ``dexp``, or of ``dexp + dexp2`` (two
    readers' cotangents of the buckets, each element's sum rounded to
    their dtype first, as autograd adds them)."""
    if not build.on_card(dexp):
        raise ValueError("moe_dispatch_bwd runs on the card only")
    _check_dtype("moe_dispatch_bwd", [("dexp", dexp)])
    if choice_slot.dim() != 3 or choice_slot.dtype != torch.int32:
        raise ValueError(f"moe_dispatch_bwd: choice_slot"
                         f"{tuple(choice_slot.shape)} must be (G, S, k) "
                         "int32")
    G, S, k = choice_slot.shape
    d = dexp.shape[-1]
    if dexp2 is not None and (dexp2.shape != dexp.shape
                              or dexp2.dtype != dexp.dtype):
        raise ValueError(f"moe_dispatch_bwd: dexp2{tuple(dexp2.shape)} "
                         f"{dexp2.dtype} is not dexp's "
                         f"{tuple(dexp.shape)} {dexp.dtype}")
    dexp = build.dense(dexp, "moe_dispatch_bwd: dexp")
    dexp2 = build.dense(dexp2, "moe_dispatch_bwd: dexp2")
    choice_slot = build.dense(choice_slot, "moe_dispatch_bwd: choice_slot")
    dx = torch.empty((G, S, d), dtype=dexp.dtype, device=dexp.device)
    lib = _lib()
    err = lib.moe_dispatch_bwd(build.ptr(dexp), build.ptr(dexp2),
                               build.ptr(choice_slot), build.ptr(dx), G * S,
                               d, k, _bf16(dexp),
                               build.stream_ptr(dexp.device))
    build.check(lib, err, "moe_dispatch_bwd")
    moe_dispatch_bwd.launches += 1
    return dx


class _Dispatch(torch.autograd.Function):
    """The dispatch kernels as one autograd function (CUDA tensors) with
    ``n`` (1 or 2) equal outputs, one for each reader of the buckets: the
    backward kernel sums their cotangents."""

    @staticmethod
    def forward(ctx, x, choice_slot, slot_src, n):
        ctx.save_for_backward(choice_slot)
        ctx.set_materialize_grads(False)
        out = moe_dispatch(x, slot_src, choice_slot.shape[-1])
        return (out,) + tuple(out.view_as(out) for _ in range(n - 1))

    @staticmethod
    def backward(ctx, *dexps):
        (choice_slot,) = ctx.saved_tensors
        gs = [build.cotangent(g) for g in dexps if g is not None]
        dx = moe_dispatch_bwd(gs[0], choice_slot, *gs[1:]) if gs else None
        return dx, None, None, None


def dispatch(x: torch.Tensor, choice_slot: torch.Tensor,
             slot_src: torch.Tensor, n: int = 1) -> Tuple[torch.Tensor, ...]:
    """The buckets (E, G C, d) of x (G, S, d) for each of ``n`` (1 or 2)
    readers, differentiable in x: the kernels on the card (the readers'
    cotangents summed in the backward kernel), :func:`dispatch_plain` under
    autograd elsewhere (the same tensor ``n`` times)."""
    _check_slots("dispatch", choice_slot, slot_src)
    if n not in (1, 2):
        raise ValueError(f"dispatch: {n} readers, 1 or 2 taken")
    if build.on_card(x):
        return _Dispatch.apply(x, choice_slot, slot_src, n)
    return (dispatch_plain(x, slot_src, choice_slot.shape[-1]),) * n


# ------------------------------------------------------------- combine


def combine_plain(rows: torch.Tensor, weights: torch.Tensor,
                  choice_slot: torch.Tensor, dtype: torch.dtype,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (G, S, d): each token's kept choices' bucket rows times their
    weights, summed in fp32 in choice order (a multiply, then an add),
    rounded once to ``dtype``; with ``residual``, ``residual + y``."""
    G, S, k = choice_slot.shape
    d = rows.shape[-1]
    flat = _padded(rows, d)
    sl = _choice_rows(choice_slot, flat.shape[0] - 1)
    acc = torch.zeros((G, S, d), dtype=torch.float32, device=rows.device)
    for i in range(k):
        acc = acc + weights[..., i, None] * flat[sl[..., i]].float()
    y = acc.to(dtype)
    return y if residual is None else residual + y


def combine_bwd_plain(dy: torch.Tensor, rows: torch.Tensor,
                      weights: torch.Tensor, choice_slot: torch.Tensor,
                      slot_src: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(drows, dweights)``: each filled bucket row's weight times its
    token's ``dy`` (rounded to rows' dtype; 0 where empty), and each kept
    choice's fp32 ``<row, dy>`` (0 where dropped)."""
    E, GC, d = rows.shape
    k = weights.shape[-1]
    src = slot_src.reshape(-1).long()
    valid = src >= 0
    s = torch.where(valid, src, 0)
    dyf = dy.reshape(-1, d).float()
    drows = torch.where(valid[:, None],
                        weights.reshape(-1)[s, None] * dyf[s // k], 0.0)
    flat = _padded(rows, d)
    sl = _choice_rows(choice_slot, flat.shape[0] - 1)
    dots = (flat[sl].float() * dy.float()[..., None, :]).sum(-1)
    dweights = torch.where(choice_slot >= 0, dots, 0.0)
    return drows.to(rows.dtype).reshape(E, GC, d), dweights


def _check_combine(what, rows, weights, choice_slot) -> None:
    _check_dtype(what, [("rows", rows)])
    if rows.dim() != 3 or weights.dtype != torch.float32 \
            or weights.shape != choice_slot.shape:
        raise ValueError(f"{what}: rows{tuple(rows.shape)} must be (E, G C, "
                         f"d), weights{tuple(weights.shape)} "
                         f"{weights.dtype} fp32 of choice_slot's shape "
                         f"{tuple(choice_slot.shape)}")


def moe_combine(rows: torch.Tensor, weights: torch.Tensor,
                choice_slot: torch.Tensor, dtype: torch.dtype,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combine kernel (CUDA tensors only): :func:`combine_plain` (the
    residual, contiguous (G, S, d) in ``dtype``, added in the kernel)."""
    if not build.on_card(rows):
        raise ValueError("moe_combine runs on the card only")
    _check_combine("moe_combine", rows, weights, choice_slot)
    if dtype not in DTYPES:
        raise ValueError(f"moe_combine: output dtype {dtype}")
    G, S, k = choice_slot.shape
    d = rows.shape[-1]
    if residual is not None and (residual.shape != (G, S, d)
                                 or residual.dtype != dtype):
        raise ValueError(f"moe_combine: residual{tuple(residual.shape)} "
                         f"{residual.dtype} is not {(G, S, d)} {dtype}")
    rows = build.dense(rows, "moe_combine: rows")
    weights = build.dense(weights, "moe_combine: weights")
    choice_slot = build.dense(choice_slot, "moe_combine: choice_slot")
    residual = build.dense(residual, "moe_combine: residual")
    y = torch.empty((G, S, d), dtype=dtype, device=rows.device)
    lib = _lib()
    err = lib.moe_combine(build.ptr(rows), build.ptr(weights),
                          build.ptr(choice_slot), build.ptr(residual),
                          build.ptr(y), G * S, d, k, _bf16(rows), _bf16(y),
                          build.stream_ptr(rows.device))
    build.check(lib, err, "moe_combine")
    moe_combine.launches += 1
    return y


def moe_combine_bwd(dy: torch.Tensor, rows: torch.Tensor,
                    weights: torch.Tensor, choice_slot: torch.Tensor,
                    slot_src: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine's backward kernels (CUDA tensors only):
    :func:`combine_bwd_plain`."""
    if not build.on_card(rows):
        raise ValueError("moe_combine_bwd runs on the card only")
    _check_combine("moe_combine_bwd", rows, weights, choice_slot)
    _check_dtype("moe_combine_bwd", [("dy", dy)])
    G, S, k = choice_slot.shape
    d = rows.shape[-1]
    if dy.shape != (G, S, d):
        raise ValueError(f"moe_combine_bwd: dy{tuple(dy.shape)}, y is "
                         f"{(G, S, d)}")
    dy, rows = build.dense(dy, "moe_combine_bwd: dy"), build.dense(rows)
    weights = build.dense(weights, "moe_combine_bwd: weights")
    choice_slot = build.dense(choice_slot, "moe_combine_bwd: choice_slot")
    slot_src = build.dense(slot_src, "moe_combine_bwd: slot_src")
    drows = torch.empty_like(rows)
    dweights = torch.empty((G, S, k), dtype=torch.float32, device=rows.device)
    lib = _lib()
    err = lib.moe_combine_bwd(build.ptr(dy), build.ptr(rows),
                              build.ptr(weights), build.ptr(choice_slot),
                              build.ptr(slot_src), build.ptr(drows),
                              build.ptr(dweights), slot_src.numel(), G * S,
                              d, k, _bf16(rows), _bf16(dy),
                              build.stream_ptr(rows.device))
    build.check(lib, err, "moe_combine_bwd")
    moe_combine_bwd.launches += 1
    return drows, dweights


class _Combine(torch.autograd.Function):
    """The combine kernels as one autograd function (CUDA tensors); a
    residual's cotangent is ``dy`` itself."""

    @staticmethod
    def forward(ctx, rows, weights, choice_slot, slot_src, dtype, residual):
        ctx.save_for_backward(rows, weights, choice_slot, slot_src)
        return moe_combine(rows, weights, choice_slot, dtype, residual)

    @staticmethod
    def backward(ctx, dy):
        rows, weights, choice_slot, slot_src = ctx.saved_tensors
        drows, dweights = moe_combine_bwd(build.cotangent(dy), rows, weights,
                                          choice_slot, slot_src)
        return (drows, dweights, None, None, None,
                dy if ctx.needs_input_grad[5] else None)


def combine(rows: torch.Tensor, weights: torch.Tensor,
            choice_slot: torch.Tensor, slot_src: torch.Tensor,
            dtype: torch.dtype, residual: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """y (G, S, d) in ``dtype`` from the buckets' outputs ``rows`` (E, G C,
    d) and the routing weights (G, S, k), plus ``residual`` where given,
    differentiable in all three: the kernels on the card, :func:`combine_plain`
    under autograd elsewhere."""
    _check_slots("combine", choice_slot, slot_src)
    if build.on_card(rows):
        return _Combine.apply(rows, weights, choice_slot, slot_src, dtype,
                              residual)
    return combine_plain(rows, weights, choice_slot, dtype, residual)


moe_route.launches = 0
moe_route_bwd.launches = 0
moe_slots.launches = 0
moe_dispatch.launches = 0
moe_dispatch_bwd.launches = 0
moe_combine.launches = 0
moe_combine_bwd.launches = 0

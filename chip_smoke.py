#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases, each printing its own lines:

1. device   — ``nvidia-smi`` name and power limit; TF32 off for the plain
              references (the kernels are fp32).
2. build    — every CUDA source compiled with ``nvcc`` for sm_90a into
              ``build/repro_torch_kernels/`` (one ``nvcc`` per source, all
              started together), with the build seconds.
3. kernels  — each kernel against its plain PyTorch version on the card at
              full width: ``lstm_cell`` (B=256, Dx=64, Dh=256; fp32 at 1e-5,
              bf16 at 3e-2) and the fused advance/reverse over one segment
              with an uneven chunk tail and one with a length-1 tail.
4. main     — ``value_and_grad_offloaded(get_model(lstm-paper).train_loss,
              runner="fused")`` on ``make_batch(lstm-paper, train_4k)``
              (B=256, S=4096), once autotuned and once with a pinned
              interval that leaves a tail segment, each held against dense
              ``torch.autograd`` of ``forward_loss`` (loss at 1e-5
              relative, each gradient leaf at 1e-4 of its max |g|); every
              kernel's launch count is read from this phase alone.
5. timing   — each kernel, its plain version and the nearest library call
              timed with CUDA events at the main path's segment shape.
6. train    — three RMSProp steps through the offloaded gradient; the
              losses must fall.

``--phases ...,profile`` adds a ``torch.profiler`` pass over one main-path
call per schedule (device kernel time by name and the device's busy share).
It is not part of the default run.  Logs too long for the output (the
ptxas report, the profile tables) go to ``--out-dir`` (default
``build/chip_smoke/`` in the checkout).

The line before the last is one JSON object ``{"kernels": [...]}`` (per
kernel: launches in the main phase, error against the plain version, times
and the least time the card could take for the same work); the last line
is ``{"ok": true, "device": {...}}``.  A failure in any phase exits non-zero
without that line.  Without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
DEFAULT_OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

PHASES = ("device", "build", "kernels", "main", "timing", "train")
OPTIONAL = ("profile",)   # run only when named in --phases
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 bandwidth (data sheet)
FP32_FLOPS = 67e12          # fp32 outside the tensor cores (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- helpers

def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cell_flops(B: int, Dx: int, Dh: int) -> float:
    # [x, h] @ W + b, then the gate point update (4 activations, 3 mul/add,
    # tanh(c')) per (row, unit)
    return 2.0 * B * (Dx + Dh) * 4 * Dh + B * 4 * Dh + 8.0 * B * Dh


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def scaled_err(a, b) -> float:
    """max |a - b| / max(|b|max, 1e-30): gradient error relative to the
    leaf's own scale."""
    scale = float(b.float().abs().max())
    return max_err(a, b) / max(scale, 1e-30)


# ----------------------------------------------------------------- phases

def phase_device(state) -> None:
    import torch

    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(q.returncode == 0, f"nvidia-smi failed: {q.stderr.strip()}")
    card = q.stdout.strip().splitlines()[0]
    state["card"] = card
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build(state) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    total = time.perf_counter() - t0
    out_dir = state["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_build.log"), "w") as f:
        for name, text in build.BUILD_LOG.items():
            f.write(f"=== {name}\n{text}\n")
    for name in build.SOURCES:
        build.load(name)
    log("[build] " + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f"; wall {total:.1f}s (ptxas report: "
        f"{os.path.join(out_dir, 'chip_smoke_build.log')})")


def _lstm_inputs(torch, dtype, B=256, Dx=64, Dh=256, seed=1):
    import numpy as np

    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.tensor(a, device="cuda").to(dtype)

    return (t((B, Dx)), t((B, Dh)), t((B, Dh)),
            t((Dx + Dh, 4 * Dh), 0.1), t((4 * Dh,), 0.1))


def _segment_case(torch, cfg, T, seed):
    """Full-width LSTM operands for one segment of T steps."""
    from repro_torch.convert import init_lstm_numpy, params_from_numpy

    import numpy as np

    rng = np.random.default_rng(seed)
    B, V, Dh = 256, cfg.vocab, cfg.d_ff
    params = params_from_numpy(
        init_lstm_numpy(seed, V, cfg.d_model, Dh), device="cuda")
    h = torch.tensor(rng.standard_normal((B, Dh)).astype(np.float32) * 0.5,
                     device="cuda")
    c = torch.tensor(rng.standard_normal((B, Dh)).astype(np.float32) * 0.5,
                     device="cuda")
    acc = torch.tensor(3.0, device="cuda")
    tok = torch.tensor(rng.integers(0, V, (T, B)), dtype=torch.int32,
                       device="cuda")
    tgt = torch.tensor(rng.integers(0, V, (T, B)), dtype=torch.int32,
                       device="cuda")
    dcarry = (torch.tensor(rng.standard_normal((B, Dh)).astype(np.float32)
                           * 0.1, device="cuda"),
              torch.tensor(rng.standard_normal((B, Dh)).astype(np.float32)
                           * 0.1, device="cuda"),
              torch.tensor(1.0, device="cuda"))
    return params, (h, c, acc), (tok, tgt), dcarry


def check_segment(torch, cfg, T, chunk, seed, label):
    """Fused advance and reverse against their plain versions; returns
    their max absolute errors."""
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models import lstm

    body = lstm.train_chain(cfg).body
    params, carry, xs, dcarry = _segment_case(torch, cfg, T, seed)
    out = sf.fused_advance_segment(body, params, carry, xs, None,
                                   chunk=chunk)
    out.ready.synchronize()
    ref = sf.advance_plain(body, params, carry, xs, None, chunk=chunk)
    torch.cuda.synchronize()
    nc = len(sf.forward_bounds(T, chunk)) - 1
    require(out.boundaries[0].shape[0] == nc == ref.boundaries[0].shape[0],
            f"{label}: boundary count {out.boundaries[0].shape[0]} != {nc}")
    adv = max(max_err(out.carry[0], ref.carry[0]),
              max_err(out.carry[1], ref.carry[1]),
              max_err(out.boundaries[0].cuda(), ref.boundaries[0]),
              max_err(out.boundaries[1].cuda(), ref.boundaries[1]))
    acc_rel = max(abs(float(out.carry[2]) - float(ref.carry[2])),
                  max_err(out.boundaries[2].cuda(), ref.boundaries[2])) \
        / max(1.0, abs(float(ref.carry[2])))
    # fp32 recurrences in two summation orders: 1e-4 on states, 1e-5 on
    # the loss accumulator (relative)
    require(adv <= 1e-4 and acc_rel <= 1e-5,
            f"{label}: fused advance off its plain version: state err {adv}"
            f", acc rel err {acc_rel}")
    dc, dp, dxd = sf.fused_reverse_segment(body, (False, False), params,
                                           carry, xs, None, dcarry,
                                           chunk=chunk)
    rdc, rdp, _ = sf.reverse_plain(body, (False, False), params, carry, xs,
                                   None, dcarry, chunk=chunk)
    torch.cuda.synchronize()
    require(dxd == [], f"{label}: unexpected dxs from the fused reverse")
    pairs = [(dp[k], rdp[k]) for k in rdp] + list(zip(dc, rdc))
    rev = max(scaled_err(a, b) for a, b in pairs)
    rev_abs = max(max_err(a, b) for a, b in pairs)
    # gradients: 1e-4 of each leaf's max |g| (fp32, different orders)
    require(rev <= 1e-4, f"{label}: fused reverse off its plain version: "
            f"scaled err {rev}")
    log(f"[kernels] {label}: T={T} chunk={chunk} nc={nc}: advance err "
        f"{adv:.3g} (acc rel {acc_rel:.3g}), reverse err {rev_abs:.3g} "
        f"(scaled {rev:.3g})")
    return adv, rev_abs


def phase_kernels(state) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.lstm_cell import lstm_cell
    from repro_torch.kernels.ref import lstm_cell_ref

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        x, h, c, w, b = _lstm_inputs(torch, dtype)
        hn, cn = lstm_cell(x, h, c, w, b)
        f = [t.float() for t in (x, h, c, w, b)]
        hr, cr = lstm_cell_ref(*f)
        torch.cuda.synchronize()
        err = max(max_err(hn, hr), max_err(cn, cr))
        ok = bool(torch.allclose(hn.float(), hr, rtol=tol, atol=tol)
                  and torch.allclose(cn.float(), cr, rtol=tol, atol=tol))
        require(ok, f"lstm_cell {dtype}: max err {err} over tol {tol}")
        log(f"[kernels] lstm_cell {str(dtype)[6:]}: max err {err:.3g} "
            f"(tol {tol})")
        errs[str(dtype)] = err
    # ragged batch edge (B not a multiple of the row tile)
    x, h, c, w, b = _lstm_inputs(torch, torch.float32, B=37, Dx=64, Dh=256)
    hn, cn = lstm_cell(x, h, c, w, b)
    hr, cr = lstm_cell_ref(x, h, c, w, b)
    require(max(max_err(hn, hr), max_err(cn, cr)) <= 1e-5,
            "lstm_cell: ragged batch edge")
    cfg = get_config("lstm-paper")
    adv, rev = check_segment(torch, cfg, T=100, chunk=7, seed=2,
                             label="uneven chunk tail")
    adv1, rev1 = check_segment(torch, cfg, T=99, chunk=7, seed=3,
                               label="length-1 tail")
    state["err"] = {"lstm_cell": errs["torch.float32"],
                    "fused_advance_segment": max(adv, adv1),
                    "fused_reverse_segment": max(rev, rev1)}


def _dense_reference(torch, params, batch):
    from repro_torch.models.lstm import forward_loss

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = forward_loss(leaves, batch["tokens"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _check_against(label, loss, grads, ref_loss, ref_grads):
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    gerr = {k: scaled_err(grads[k], ref_grads[k]) for k in ref_grads}
    finite = all(bool(g.isfinite().all()) for g in grads.values())
    require(finite and math.isfinite(float(loss)),
            f"{label}: non-finite loss or gradients")
    require(all(grads[k].shape == ref_grads[k].shape for k in ref_grads),
            f"{label}: gradient shapes differ from the parameters'")
    require(rel <= 1e-5, f"{label}: loss rel err {rel} > 1e-5")
    worst = max(gerr.values())
    require(worst <= 1e-4, f"{label}: gradient scaled err {gerr} > 1e-4")
    return rel, worst


def phase_main(state) -> None:
    import torch

    from repro_torch import api
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.convert import init_lstm_numpy, params_from_numpy
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models.model_factory import get_model

    cfg = get_config("lstm-paper")
    shape = SHAPES["train_4k"]
    model = get_model(cfg)
    batch = make_batch(cfg, shape, seed=0)
    params = params_from_numpy(
        init_lstm_numpy(0, cfg.vocab, cfg.d_model, cfg.d_ff))
    t0 = time.perf_counter()
    ref_loss, ref_grads = _dense_reference(torch, params, batch)
    torch.cuda.synchronize()
    log(f"[main] dense autograd reference: loss {float(ref_loss):.6f} "
        f"in {time.perf_counter() - t0:.2f}s")
    state.update(cfg=cfg, model=model, batch=batch, params=params)

    kernels = {"lstm_cell": lc.lstm_cell,
               "fused_advance_segment": sf.fused_advance_segment,
               "fused_reverse_segment": sf.fused_reverse_segment}
    for fn in kernels.values():
        fn.launches = 0
    runs = []
    for label, kw in (("autotuned", {}), ("pinned", {"interval": 1000})):
        before = {k: fn.launches for k, fn in kernels.items()}
        vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                          device="cuda", **kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tune, stats, plan = api.last_tune(), api.last_stats(), \
            api.last_plan()
        l1_peak = torch.cuda.max_memory_allocated()
        rel, gerr = _check_against(label, loss, grads, ref_loss, ref_grads)
        grew = {k: fn.launches - before[k] for k, fn in kernels.items()}
        segs = plan.num_segments
        # the autotune probe runs the fused advance 1 + repeats times
        probe = (1 + api.GLOBAL_TUNER.repeats) \
            if tune.source == "measured" else 0
        require(grew["fused_advance_segment"] == segs + probe
                and grew["fused_reverse_segment"] == segs,
                f"{label}: fused launches {grew} for {segs} segments "
                f"(+{probe} probe launches)")
        require(stats.fused_segments == 2 * segs,
                f"{label}: stats.fused_segments {stats.fused_segments}")
        log(f"[main] {label}: tune I={tune.interval} s={tune.slots} "
            f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); "
            f"plan {plan.plan_id} ({segs} segments)")
        log(f"[main] {label}: loss {float(loss):.6f} (rel err {rel:.3g}), "
            f"grad scaled err {gerr:.3g}; wall {wall:.3f}s; launches {grew}")
        log(f"[main] {label}: stats advances={stats.advances} "
            f"backwards={stats.backwards} l2_stores={stats.l2_stores} "
            f"host_dispatches={stats.host_dispatches} "
            f"fused_segments={stats.fused_segments} "
            f"fused_boundary_copies={stats.fused_boundary_copies} "
            f"l2_peak_bytes={stats.l2_peak_bytes} "
            f"l1_peak_device_bytes={l1_peak} "
            f"store_stall_s={stats.store_stall_s:.4f} "
            f"prefetch_stall_s={stats.prefetch_stall_s:.4f}")
        runs.append({"label": label, "interval": tune.interval,
                     "slots": tune.slots, "t_a": tune.t_a, "t_t": tune.t_t,
                     "wall_s": wall, "l2_peak_bytes": stats.l2_peak_bytes,
                     "l1_peak_device_bytes": l1_peak})
    state["launches"] = {k: fn.launches for k, fn in kernels.items()}
    for k, n in state["launches"].items():
        require(n > 0, f"{k} was not launched on the main path")
    state["runs"] = runs


def _time_segment_kernels(torch, cfg, T, slots):
    """Fused advance/reverse and their plain versions timed over one
    full-width segment of T steps chunked as the runner chunks it, with the
    least time the card could take for the same work."""
    from repro_torch.core.schedule import chunk_length
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models import lstm

    B, Dx, Dh, V = 256, cfg.d_model, cfg.d_ff, cfg.vocab
    K = Dx + Dh
    chunk = chunk_length(T, slots) or T
    body = lstm.train_chain(cfg).body
    params, carry, xs, dcarry = _segment_case(torch, cfg, T, seed=4)
    out = {"T": T, "chunk": chunk}
    iters = max(2, min(100, 2000 // T))
    ms_k = cuda_ms(lambda: sf.fused_advance_segment(
        body, params, carry, xs, None, chunk=chunk), iters)
    ms_p = cuda_ms(lambda: sf.advance_plain(body, params, carry, xs, None,
                                            chunk=chunk), iters)
    nc = len(sf.forward_bounds(T, chunk)) - 1
    pbytes = 4.0 * (V * Dx + K * 4 * Dh + 4 * Dh + Dh * V + V)
    step_flops = cell_flops(B, Dx, Dh) + 2.0 * B * Dh * V + 4.0 * B * V
    nbytes = pbytes + 8.0 * T * B + 4.0 * (2 * (2 * B * Dh + 1)
                                            + nc * (2 * B * Dh + 1))
    out["fused_advance_segment"] = (ms_k, ms_p) + bound_ms(nbytes,
                                                           T * step_flops)
    iters = max(1, min(50, 1000 // T))
    ms_k = cuda_ms(lambda: sf.fused_reverse_segment(
        body, (False, False), params, carry, xs, None, dcarry, chunk=chunk),
        iters)
    ms_p = cuda_ms(lambda: sf.reverse_plain(
        body, (False, False), params, carry, xs, None, dcarry, chunk=chunk),
        iters)
    _, nc_r, _ = sf.reverse_layout(T, chunk)
    recompute = (nc_r - 1) * chunk + T
    back = (2.0 * B * Dh * V + 4.0 * B * V      # logits, softmax
            + 2.0 * B * Dh * V                  # dh from dlogits
            + 20.0 * B * Dh                     # the cell's vjp
            + 2.0 * B * 4 * Dh * K              # [dx, dh] = dz W^T
            + 2.0 * B * (K + 1) * 4 * Dh        # dW, db
            + 2.0 * B * (Dh + 1) * V            # dw_out, db_out
            + B * Dx)                           # demb
    nbytes = 2 * pbytes + 8.0 * T * B + 4.0 * 3 * (2 * B * Dh + 1)
    out["fused_reverse_segment"] = (ms_k, ms_p) + bound_ms(
        nbytes, recompute * cell_flops(B, Dx, Dh) + T * back)
    return out


def phase_timing(state) -> None:
    import torch

    from repro_torch.kernels.lstm_cell import lstm_cell
    from repro_torch.kernels.ref import lstm_cell_ref

    cfg = state["cfg"]
    B, Dx, Dh = 256, cfg.d_model, cfg.d_ff
    K = Dx + Dh
    rows = []

    # kernel 1 and its yardsticks
    x, h, c, w, b = _lstm_inputs(torch, torch.float32)
    perm = torch.cat([torch.arange(0, Dh), torch.arange(Dh, 2 * Dh),
                      torch.arange(3 * Dh, 4 * Dh),
                      torch.arange(2 * Dh, 3 * Dh)]).cuda()   # i,f,g,o
    w_ih = w[:Dx, perm].t().contiguous()
    w_hh = w[Dx:, perm].t().contiguous()
    b_ih = b[perm].clone()
    b_ih[Dh:2 * Dh] += 1.0    # the +1 forget bias
    b_hh = torch.zeros_like(b_ih)
    hl, cl = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    hr, cr = lstm_cell_ref(x, h, c, w, b)
    require(max_err(hl, hr) <= 1e-5 and max_err(cl, cr) <= 1e-5,
            "torch.lstm_cell yardstick does not compute the same function")
    ms_k = cuda_ms(lambda: lstm_cell(x, h, c, w, b), 200)
    ms_p = cuda_ms(lambda: lstm_cell_ref(x, h, c, w, b), 200)
    ms_l = cuda_ms(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih,
                                           b_hh), 200)
    nbytes = 4.0 * (B * Dx + 4 * B * Dh + K * 4 * Dh + 4 * Dh)
    bms, by = bound_ms(nbytes, cell_flops(B, Dx, Dh))
    rows.append(("lstm_cell", "src/repro_torch/kernels/csrc/lstm_cell.cu",
                 "src/repro/kernels/lstm_cell.py:38", ms_k, ms_p, bms, by,
                 ms_l))

    # kernels 2 and 3 at the autotuned main path's segment shape
    run = state["runs"][0]
    seg = _time_segment_kernels(torch, cfg, run["interval"], run["slots"])
    for name, line in (("fused_advance_segment", "482"),
                       ("fused_reverse_segment", "495")):
        k_ms, p_ms, b_ms, by = seg[name]
        rows.append((name, "src/repro_torch/kernels/csrc/segment_fused.cu",
                     f"src/repro/kernels/segment_pallas.py:{line}", k_ms,
                     p_ms, b_ms, by, None))
    # and at the pinned run's segment shape (long segments, 16 chunks)
    pinned = state["runs"][1]
    long_seg = _time_segment_kernels(torch, cfg, pinned["interval"],
                                     pinned["slots"])
    for name in ("fused_advance_segment", "fused_reverse_segment"):
        k_ms, p_ms, b_ms, by = long_seg[name]
        log(f"[timing] {name} at T={long_seg['T']} chunk="
            f"{long_seg['chunk']}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {by})")

    out = []
    for name, src, rep, k_ms, p_ms, b_ms, by, l_ms in rows:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": state["launches"][name],
                    "max_abs_err": state["err"][name], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": l_ms})
        log(f"[timing] {name}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by}, library "
            f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}); launches "
            f"{state['launches'][name]}")
    log(f"[timing] segment shape: T={seg['T']} chunk={seg['chunk']} B={B} "
        f"({state['card']})")
    state["kernels_json"] = out


def phase_train(state) -> None:
    from repro_torch import api
    from repro_torch.optim import rmsprop

    model, params, batch = state["model"], state["params"], state["batch"]
    vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                      device="cuda")
    opt = rmsprop(1e-3)
    opt_state = opt.init(params)
    losses = []
    for step in range(3):
        loss, grads = vg(params, batch)
        losses.append(float(loss))
        params, opt_state = opt.update(grads, opt_state, params, step)
    log(f"[train] losses {losses}")
    require(losses[0] > losses[1] > losses[2],
            f"RMSProp losses did not fall: {losses}")


def phase_profile(state) -> None:
    """Where one offloaded gradient's time goes, per schedule of the main
    phase: device time by kernel (``torch.profiler``) against the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api

    model, params, batch = state["model"], state["params"], state["batch"]
    os.makedirs(state["out_dir"], exist_ok=True)
    for run in state["runs"]:
        kw = {"interval": run["interval"]} if run["label"] == "pinned" \
            else {}
        vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                          device="cuda", **kw)
        vg(params, batch)   # warm: the schedule is cached, kernels loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vg(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((us, e.count, e.key))
        rows.sort(reverse=True)
        busy_s = sum(r[0] for r in rows) / 1e6
        path = os.path.join(state["out_dir"], f"profile_{run['label']}.txt")
        with open(path, "w") as f:
            f.write(f"# {state['card']}; one offloaded gradient, "
                    f"I={run['interval']}; wall {wall:.6f} s\n")
            f.write("# device_us\tcount\tname\n")
            for us, count, key in rows:
                f.write(f"{us:.1f}\t{count}\t{key}\n")
        if not rows:
            log(f"[profile] {run['label']}: the profiler saw no device time "
                "(device busy share not measured)")
            continue
        log(f"[profile] {run['label']} (I={run['interval']}): wall "
            f"{wall:.4f}s, device busy {busy_s:.4f}s "
            f"({100 * busy_s / wall:.1f}% of the wall); table "
            f"{path}")
        for us, count, key in rows[:6]:
            log(f"[profile]   {us / 1e3:10.3f} ms  x{count:<6d} {key[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPTIONAL))
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="directory for the build log and profile tables")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPTIONAL)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    state = {"out_dir": os.path.abspath(args.out_dir)}
    steps = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "main": phase_main,
             "timing": phase_timing, "train": phase_train,
             "profile": phase_profile}
    for name in PHASES + OPTIONAL:
        if name in phases:
            t0 = time.perf_counter()
            steps[name](state)
            log(f"[{name}] done in {time.perf_counter() - t0:.1f}s")
    if "kernels_json" in state:
        print(json.dumps({"kernels": state["kernels_json"]}), flush=True)
    if set(PHASES) <= set(phases):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases, each printing its own lines:

1. device   — ``nvidia-smi`` name and power limit; TF32 off for the plain
              references (the kernels are fp32 inside).
2. build    — every CUDA source compiled with ``nvcc`` for sm_90a into
              ``build/repro_torch_kernels/`` (one ``nvcc`` per source, all
              started together), with the build seconds; ``cuobjdump
              -sass`` counts the tensor-core (HMMA) instructions of the
              bf16 flash and SSD kernels, which must issue them.
3. kernels  — each kernel against its plain PyTorch version on the card:
              ``lstm_cell`` (B=256, Dx=64, Dh=256; fp32 at 1e-5, bf16 at
              3e-2; its step loop over a recompute chunk of the pinned
              run, step by step, and bit for bit on two calls), the fused
              advance/reverse over one segment with an
              uneven chunk tail and one with a length-1 tail, the fused
              advance at the pinned run's segment shape (its boundaries
              and exit state bit for bit those of one run of the step
              loop from the same entry; two calls bit for bit equal),
              ``flash_attention`` (gemma2-2b's layer shape in bf16 and
              fp32, phi3.5-moe's in bf16 (32 heads / 8 KV heads of 128,
              no softcap), D=64 and 256, GQA, window < S, softcap, Sq < Sk,
              ragged edges, rows that see no key; its logsumexp at 1e-5 of
              the plain forward's) and ``ssd_scan`` (mamba2-370m's layer
              shape in bf16 and fp32, a ragged batch*heads and chunk tail
              with an entry state).  Outputs are held per element at
              ``TOL``: rtol times |ref| plus atol times an RMS of the
              reference (attention's row, the SSD head's sequence); at the
              bf16 layer shapes the script also shows
              that an output one kv tile short, or one that drops a chunk's
              carried state, fails that check.  The fused reverse is also
              held at the pinned run's segment shape (T=1000, its chunk),
              and it and the bf16 flash kernel must give the same bits on
              two calls; a bf16 head dim outside {16, 32, 64, 128, 256}
              must be refused.
4. main     — ``value_and_grad_offloaded(get_model(lstm-paper).train_loss,
              runner="fused")`` on ``make_batch(lstm-paper, train_4k)``
              (B=256, S=4096), once autotuned and once with a pinned
              interval that leaves a tail segment, each held against dense
              ``torch.autograd`` of ``forward_loss`` (loss at 1e-5
              relative, each gradient leaf at 1e-4 of its max |g|); the LSTM
              kernels' launch counts are read from this phase alone, kernel
              1's launches and steps also by caller (the advance's chunks,
              the reverse's recompute), each held to what the plan implies.
5. strategies — the paper's baselines and its step-granular interpreter on
              ``lstm-paper`` at the same width, B=256, over the first 2048
              steps of ``train_4k`` (``STRATEGIES_T``): through
              ``value_and_grad_offloaded(device="cuda")``, the interpreted
              multistage engine pinned (I=256) and autotuned, Revolve with
              the pinned run's Level-1 slots, and store-all; each held to
              phase ``main``'s gates against dense autograd, its advances to
              the port's own plan (``plan.total_advances()``,
              ``count_advances(revolve_schedule(n, s))``, ``n``), and the
              ``lstm_cell`` kernel's launches (counted from zero for each
              run) to one a chain step: the baselines' forward sweep, each
              advance, each backward's recompute and each autotune probe
              step.
6. level2   — the other Level-2 backends through the front door on
              ``lstm-paper`` at ``train_4k``, ``runner="fused"``, each under
              phase ``main``'s gates and launch counts: ``storage="disk"``
              autotuned (no checkpoint left, live bytes 0 after);
              ``"tiered"`` pinned at I=256 (16 boundaries; host RAM at
              the same I first) with fast tiers of 16, 8 and 1 states (fast
              peak equal to
              ``fast_peak_bytes_model``, evictions to the plan's spills,
              prefetch depth to its distance) and autotuned with 64 states
              (``T_T_slow`` > 0, the reference's interval rule);
              ``"compressed"`` autotuned (each leaf within 5e-2 of its
              scale, the reference's bound; under half the raw bytes
              written).  The slow tier is a directory under the out-dir
              (its filesystem printed, removed afterwards).
7. resume   — crash consistency on ``lstm-paper`` at ``train_4k``,
              ``runner="fused"``, I=256 (16 segments), the write-ahead
              journal in a directory under the out-dir (its filesystem and
              the cost of one commit barrier printed), deterministic
              algorithms on: the unjournaled and the journaled fault-free
              gradient in turns (phase ``main``'s gates and launch counts,
              the journaled bit for bit the unjournaled; walls, journal
              bytes and barriers); a writer kill at every forward store
              (0-16) and a failed fetch at every reverse fetch (0-15), each
              resumed with ``resume_offloaded`` (bit for bit the fault-free
              run, ``replayed_advances`` <= I as the journal implies, the
              fused kernels' launches and kernel 1's steps by caller as
              the resume's segments imply; the first, middle and last of
              each if the loops are estimated over 90 s); a torn STORE
              record; a flipped byte (``ChecksumError`` on open, then
              ``journal_repair=True``); a journaled tiered run at 8 states
              (counters equal to the plan); one autotuned journaled
              gradient (wall, I, journal bytes, barriers).
8. dense    — ``value_and_grad_offloaded(get_model(gemma2-2b).train_loss)``
              (``runner="compiled"``, autotuned) at full width and depth (26
              layers, 13 chain steps), ``train_4k`` with the global batch
              cut from 256 to 2, weights from a seeded CUDA generator; held
              against dense autograd of ``train_loss`` (loss 1e-5 relative,
              each gradient leaf 1e-3 of its max |g|).  ``flash_attention``
              launches are read from the first offloaded call alone (the
              main path, autotune probe included); a second and a third
              call, with the schedule cached, are timed against a second
              (warm) dense call, each with the caching allocator's retries
              and device mallocs.
              Then one ``strategy="revolve"`` run (4 slots) under the same
              gates, ``flash_attention`` launched twice a step as above, and
              one ``storage="tiered"`` run at I=1 with a fast tier of 4
              boundary states over disk (fast peak and evictions as the
              model and plan say; a bf16 boundary spilled and promoted
              back bit for bit).
9. ssm      — the same for ``mamba2-370m`` (48 layers, batch cut to 4)
              and ``ssd_scan``.
10. moe     — the same for ``phi3.5-moe-42b`` at full width (d_model
              4096, 16 experts top-2 of d_ff 6400, capacity factor 1.25),
              batch cut to 2 and depth cut to ``MOE_LAYERS`` (4 chain steps
              of one ``attn_moe`` layer), ``flash_attention`` once a chain
              step; the reference's gradients wait in page-locked host
              memory while the offloaded calls run (in every decoder
              phase), and every top-2 routing choice of the offloaded call
              (forward sweep, probe, the reverse's recompute) must equal
              the reference forward's.
11. timing  — each kernel, its plain version and the nearest library call
              timed with CUDA events at the main path's shapes, with the
              achieved TFLOP/s where the bound is operations; the fused
              reverse at T=1000 also by part (recompute, hoisted products,
              walk, gradient reductions: device time of its kernels under
              ``torch.profiler``), and the fused advance (step loop,
              readout, loss and boundaries, finalize), its chunk's readout
              and loss with the boundary written to page-locked host
              memory and to device memory, and a composite of library
              calls computing the same (cuDNN's multi-step LSTM,
              ``F.linear``, ``F.cross_entropy``); ``ssd_scan`` by pass
              (the same); the step loop over a recompute chunk per launch
              and per step, beside cuDNN's multi-step LSTM on the same
              chunk; ``flash_attention`` at gemma2-2b's and at
              phi3.5-moe's shape (there beside SDPA, the same function).
12. train   — three RMSProp steps through the offloaded LSTM gradient; the
              losses must fall.

``--phases ...,profile`` adds a ``torch.profiler`` pass over one main-path
call per LSTM schedule and one offloaded call in each decoder phase (device
kernel time by name and the device's busy share; for the LSTM, the device
time under each fused segment wrapper, kernel 1's by caller).
It is not part of the default run.  Logs too long for the output (the
ptxas report, the profile tables) go to ``--out-dir`` (default
``build/chip_smoke/`` in the checkout).

The line before the last is one JSON object ``{"kernels": [...]}`` (per
kernel: launches in the phases whose paths run it, error against the plain
version at the main path's shapes, times and the least time the card could
take for the same work); the last line
is ``{"ok": true, "device": {...}}``.  A failure in any phase exits non-zero
without that line.  Without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
DEFAULT_OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

PHASES = ("device", "build", "kernels", "main", "strategies", "level2",
          "resume", "dense", "ssm", "moe", "timing", "train")
OPTIONAL = ("profile",)   # run only when named in --phases
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 bandwidth (data sheet)
FP32_FLOPS = 67e12          # fp32 outside the tensor cores (data sheet)
BF16_TC_FLOPS = 989e12      # bf16 tensor cores, dense (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- helpers

def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events.
    The calls are queued behind a busy wait on the card as long as the host
    takes to issue them, so the events time the device's work and not the
    host's Python between launches (a wrapper that synchronises is timed
    as it runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: at least the host's issue time, at most ~1 s
    torch.cuda._sleep(int(min(1.2 * host_s * iters, 1.0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cell_flops(B: int, Dx: int, Dh: int) -> float:
    # [x, h] @ W + b, then the gate point update (4 activations, 3 mul/add,
    # tanh(c')) per (row, unit)
    return 2.0 * B * (Dx + Dh) * 4 * Dh + B * 4 * Dh + 8.0 * B * Dh


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def excess(a, ref, rtol: float, dims=(-1,)) -> float:
    """Per element, the part of |a - ref| beyond ``rtol * |ref|``, over the
    RMS of ``ref`` across ``dims`` (by default the element's row: one
    head's output at one position); the largest over the tensor.  ``a``
    passes at ``(rtol, atol)`` when this is at most ``atol``: the tolerance
    follows the size of each element and of its neighbours, so small
    outputs are held as tightly as large ones."""
    a, r = a.float(), ref.float()
    rms = r.pow(2).mean(dims, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((a - r).abs() - rtol * r.abs()).clamp_min(0).div(rms).max())


# (rtol, atol) of the kernels' outputs against their plain versions, atol in
# units of an RMS of the reference: attention's per row (one head at one
# position; along a causal sequence rows differ in size by orders of
# magnitude), the SSD scan's per head over the whole sequence (y_l is an
# intra-chunk and an inter-chunk sum that may nearly cancel, so a row can be
# far smaller than the sums that make it).  fp32: sums in other orders.
# bf16: one rounding of the output (1 ulp is at most 2^-7 of |ref|) and, in
# attention only, p rounded to bf16 at another point of the softmax
# (unnormalised, against the running max, where the plain version rounds the
# normalised p): up to 2^-9 of each |p_j v_j|, which the row's RMS does not
# follow where the terms cancel.
TOL = {"flash_attention": {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 2e-2)},
       "ssd_scan": {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-3)}}
SSD_Y_DIMS, SSD_H_DIMS = (1, 3), (2, 3)   # y (B, T, H, P), h (B, H, P, N)


def scaled_err(a, b) -> float:
    """max |a - b| / max(|b|max, 1e-30): gradient error relative to the
    leaf's own scale (``b`` brought to ``a``'s device, where a decoder
    phase keeps its reference on the host)."""
    b = b.to(a.device, non_blocking=True)
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
    # the bf16 kernels that must run on the tensor cores
    for lib, kernels in (("flash_attention", ("flash_fwd_bf16_kernel",)),
                         ("ssd_scan", ("ssd_state_bf16_kernel",
                                       "ssd_out_bf16_kernel"))):
        counts = hmma_counts(build.library_path(lib))
        if counts is None:
            log(f"[build] {lib}: cuobjdump not found, HMMA not counted")
            continue
        for kern in kernels:
            n = sum(v for k, v in counts.items() if kern in k)
            require(n > 0, f"{lib}: {kern} issues no HMMA instruction")
            log(f"[build] {lib}: {kern} has {n} HMMA instructions "
                "(cuobjdump -sass)")


def hmma_counts(lib_path):
    """HMMA instructions per kernel in ``cuobjdump -sass`` of a built
    library, keyed by the mangled name; None without cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


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
    ref = sf.advance_plain(lstm.plain_body, params, carry, xs, None,
                           chunk=chunk)
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
    rdc, rdp, _ = sf.reverse_plain(lstm.plain_body, (False, False), params,
                                   carry, xs, None, dcarry, chunk=chunk)
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


def pinned_chunk(T: int = 1000) -> int:
    """The chunk of the pinned main-path run's segments (interval T, the
    default slots): what phase ``main`` runs at ``interval=1000``."""
    from repro_torch.api.autotune import default_slots
    from repro_torch.core.schedule import chunk_length

    return chunk_length(T, default_slots(T)) or T


def check_reverse_pinned(torch, cfg, T=1000, seed=5):
    """The fused reverse at the pinned run's segment shape (T=1000, its
    chunk) against its plain version, and two calls bit for bit equal (the
    kernels sum in a fixed order, no float atomics); returns the max abs
    error."""
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models import lstm

    body = lstm.train_chain(cfg).body
    chunk = pinned_chunk(T)
    params, carry, xs, dcarry = _segment_case(torch, cfg, T, seed)
    args = (body, (False, False), params, carry, xs, None, dcarry)
    dc, dp, _ = sf.fused_reverse_segment(*args, chunk=chunk)
    dc2, dp2, _ = sf.fused_reverse_segment(*args, chunk=chunk)
    rdc, rdp, _ = sf.reverse_plain(lstm.plain_body, *args[1:], chunk=chunk)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(dc, dc2)) and all(
        torch.equal(dp[k], dp2[k]) for k in dp)
    require(same, f"fused reverse T={T}: two calls differ")
    pairs = [(dp[k], rdp[k]) for k in rdp] + list(zip(dc, rdc))
    rev = max(scaled_err(a, b) for a, b in pairs)
    rev_abs = max(max_err(a, b) for a, b in pairs)
    st = max(max_err(a, b) for a, b in zip(dc, rdc))
    require(rev <= 1e-4 and st <= 1e-5,
            f"fused reverse T={T} chunk={chunk}: scaled err {rev} (1e-4), "
            f"state err {st} (1e-5)")
    log(f"[kernels] fused reverse at the pinned shape T={T} chunk={chunk}: "
        f"err {rev_abs:.3g} (scaled {rev:.3g}, states {st:.3g}); two calls "
        "bit for bit equal")
    return rev_abs


def check_advance_pinned(torch, cfg, T=1000, seed=8):
    """The fused advance at the pinned run's segment shape (T=1000, its
    chunk): its chunk-entry boundaries and exit (h, c) bit for bit those of
    one run of the step loop (``lstm_cell_token_steps``) over the segment
    from the same entry, one step-loop launch a forward chunk; two calls
    bit for bit equal, the loss accumulator and its boundaries included;
    and against its plain version at ``check_segment``'s gates.  Returns
    the max abs error of the states."""
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models import lstm

    body = lstm.train_chain(cfg).body
    chunk = pinned_chunk(T)
    params, carry, xs, _ = _segment_case(torch, cfg, T, seed)
    adv = sf.fused_advance_segment
    n0 = adv.cell_launches
    outs = [adv(body, params, carry, xs, None, chunk=chunk)
            for _ in range(2)]
    for out in outs:
        out.ready.synchronize()
    starts = sf.forward_bounds(T, chunk)[:-1]
    require(adv.cell_launches - n0 == 2 * len(starts),
            f"fused advance T={T}: {adv.cell_launches - n0} step-loop "
            f"launches in two calls of {len(starts)} chunks")
    a, b = [list(o.carry) + list(o.boundaries) for o in outs]
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            f"fused advance T={T}: two calls differ")
    h0, c0, _ = carry
    hs = torch.empty((T + 1,) + tuple(h0.shape), device="cuda")
    cs = torch.empty_like(hs)
    hs[0], cs[0] = h0, c0
    lc.lstm_cell_token_steps(xs[0], params["emb"], hs, cs, params["w"],
                             params["b"])
    torch.cuda.synchronize()
    out = outs[0]
    require(torch.equal(out.boundaries[0], hs[starts].cpu())
            and torch.equal(out.boundaries[1], cs[starts].cpu())
            and torch.equal(out.carry[0], hs[T])
            and torch.equal(out.carry[1], cs[T]),
            f"fused advance T={T}: states differ from the step loop's")
    ref = sf.advance_plain(lstm.plain_body, params, carry, xs, None,
                           chunk=chunk)
    torch.cuda.synchronize()
    err = max(max_err(out.carry[0], ref.carry[0]),
              max_err(out.carry[1], ref.carry[1]),
              max_err(out.boundaries[0].cuda(), ref.boundaries[0]),
              max_err(out.boundaries[1].cuda(), ref.boundaries[1]))
    acc_rel = max(abs(float(out.carry[2]) - float(ref.carry[2])),
                  max_err(out.boundaries[2].cuda(), ref.boundaries[2])) \
        / max(1.0, abs(float(ref.carry[2])))
    require(err <= 1e-4 and acc_rel <= 1e-5,
            f"fused advance T={T}: off its plain version: state err {err}, "
            f"acc rel err {acc_rel}")
    log(f"[kernels] fused advance at the pinned shape T={T} chunk={chunk} "
        f"({len(starts)} chunks, one step-loop launch each): err {err:.3g} "
        f"(acc rel {acc_rel:.3g}); boundaries and exit state bit for bit "
        "those of one run of the step loop from the same entry; two calls "
        "bit for bit equal")
    return err


def check_step_loop(torch, cfg, seed=6):
    """The step loop (``lstm_cell_token_steps``, one cooperative launch)
    over one recompute chunk of the pinned run at full width (B=256),
    step by step against ``lstm_cell_ref`` (fp32, 1e-5) with its [x, h]
    rows and gate activations, and bit for bit on two calls; returns the
    max abs error."""
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels.ref import lstm_cell_ref

    L = pinned_chunk()
    params, (h0, c0, _), (tok, _), _ = _segment_case(torch, cfg, L, seed)
    emb, w, b = params["emb"], params["w"], params["b"]
    B, Dh = h0.shape
    K = emb.shape[1] + Dh
    outs = []
    for _ in range(2):
        hs = torch.empty((L + 1, B, Dh), device="cuda")
        cs = torch.empty_like(hs)
        hs[0], cs[0] = h0, c0
        xh = torch.empty((L, B, K), device="cuda")
        acts = torch.empty((L, B, 4 * Dh), device="cuda")
        before = lc.lstm_cell.launches
        lc.lstm_cell_token_steps(tok, emb, hs, cs, w, b, xh=xh, acts=acts)
        require(lc.lstm_cell.launches == before + 1,
                "lstm_cell step loop: not one launch for the run")
        outs.append((hs, cs, xh, acts))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*outs)),
            "lstm_cell step loop: two calls differ")
    hs, cs, xh, acts = outs[0]
    err = 0.0
    for t in range(L):
        x = emb[tok[t].long()]
        xr = torch.cat([x, hs[t]], 1)
        hr, cr = lstm_cell_ref(x, hs[t], cs[t], w, b)
        i, f, o, g = (xr @ w + b).chunk(4, 1)
        ar = torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1.0),
                        torch.sigmoid(o), torch.tanh(g)], 1)
        require(torch.equal(xh[t], xr), f"step loop: xh[{t}] differs")
        err = max(err, max_err(hs[t + 1], hr), max_err(cs[t + 1], cr),
                  max_err(acts[t], ar))
    require(err <= 1e-5, f"lstm_cell step loop: max err {err} over 1e-5")
    log(f"[kernels] lstm_cell step loop: L={L} B={B} Dh={Dh} in one launch:"
        f" max err {err:.3g} (tol 1e-5) step by step; two calls bit for bit"
        " equal")
    return err


def _randn(torch, rng, shape, dtype, scale=1.0):
    import numpy as np

    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.tensor(a, device="cuda").to(dtype)


# label, (B, Sq, Sk, H, G, D), dtype name, keyword arguments; the first
# two are every gemma2-2b layer at the dense phase's shape, the third every
# phi3.5-moe layer at the moe phase's (no softcap, no window, scale D^-0.5)
GEMMA_KW = {"softcap": 50.0, "scale": 256 ** -0.5}
FLASH_CASES = (
    ("gemma2-2b layer", (2, 4096, 4096, 8, 4, 256), "bfloat16", GEMMA_KW),
    ("gemma2-2b layer fp32", (2, 4096, 4096, 8, 4, 256), "float32",
     GEMMA_KW),
    ("phi3.5-moe layer", (2, 4096, 4096, 32, 8, 128), "bfloat16", {}),
    ("fp32 D=64 window<S ragged", (2, 1000, 1000, 4, 1, 64), "float32",
     {"window": 100, "softcap": 30.0}),
    ("bf16 D=64 Sq<Sk ragged", (1, 300, 777, 4, 2, 64), "bfloat16",
     {"window": 200}),
    ("fp32 D=64 non-causal", (2, 129, 129, 4, 4, 64), "float32",
     {"causal": False}),
    ("bf16 D=128 window<S softcap ragged", (2, 1000, 1000, 8, 2, 128),
     "bfloat16", {"window": 300, "softcap": 30.0}),
    ("bf16 D=64 non-causal", (2, 129, 129, 4, 4, 64), "bfloat16",
     {"causal": False}),
)


def check_flash(torch, label, dims, dtype, kw, seed):
    """The flash kernel against its plain version (per element, ``TOL``),
    and its logsumexp against the plain chunked forward's; returns the max
    abs error."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import _chunked_fwd

    B, Sq, Sk, H, G, D = dims
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = _randn(torch, rng, (B, Sq, H, D), dt)
    k = _randn(torch, rng, (B, Sk, G, D), dt)
    v = _randn(torch, rng, (B, Sk, G, D), dt)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    _, ref_lse = _chunked_fwd(q, k, v, kw.get("causal", True),
                              kw.get("window"), kw.get("softcap"), 1024,
                              kw.get("scale"))
    torch.cuda.synchronize()
    rtol, atol = TOL["flash_attention"][dtype]
    err, ex = max_err(out, ref), excess(out, ref, rtol)
    lse_err = max_err(lse, ref_lse)
    lse_tol = 1e-5 * max(1.0, float(ref_lse.abs().max()))
    require(bool(torch.isfinite(out.float()).all()) and ex <= atol,
            f"flash_attention {label}: scaled excess {ex} over {atol} "
            f"(rtol {rtol}; max abs err {err})")
    require(lse_err <= lse_tol, f"flash_attention {label}: lse err "
            f"{lse_err} over {lse_tol}")
    log(f"[kernels] flash_attention {label} {dims} {dtype}: max abs err "
        f"{err:.3g}, scaled excess {ex:.3g} (rtol {rtol}, atol {atol} x "
        f"row RMS), lse err {lse_err:.3g}")
    if label == "gemma2-2b layer":
        out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
        require(torch.equal(out, out2) and torch.equal(lse, lse2),
                f"flash_attention {label}: two calls differ")
        log(f"[kernels] flash_attention {label}: two calls bit for bit "
            "equal")
        # the check rejects a kernel that skips one kv tile: the plain
        # version with keys 0..31 masked (K/V cut, queries kept at the end)
        bad = fa.flash_attention_plain(q, k[:, 32:].contiguous(),
                                       v[:, 32:].contiguous(), **kw)
        ex_bad = excess(bad, ref, rtol)
        require(ex_bad > atol, f"flash_attention {label}: an output that "
                f"skips one kv tile passes the check ({ex_bad})")
        log(f"[kernels] flash_attention {label}: one kv tile skipped would "
            f"give a scaled excess of {ex_bad:.3g}")
    return err


def check_flash_unseen_rows(torch):
    """Rows that see no key (Sq > Sk, causal) give 0, never NaN, in fp32 and
    bf16; the rest match the plain version.  A bf16 head dim outside the
    tensor-core kernel's {16, 32, 64, 128, 256} is refused."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(11)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = _randn(torch, rng, (1, 100, 2, 64), dt)
        k = _randn(torch, rng, (1, 50, 2, 64), dt)
        v = _randn(torch, rng, (1, 50, 2, 64), dt)
        out, _ = fa.flash_attention_fwd(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        rtol, atol = TOL["flash_attention"][dtype]
        ex = excess(out[:, 50:], ref[:, 50:], rtol)
        require(bool(torch.isfinite(out.float()).all())
                and float(out[:, :50].float().abs().max()) == 0.0
                and ex <= atol,
                f"flash_attention {dtype}: rows that see no key are not 0, "
                f"or the rest are off the plain version ({ex})")
        log(f"[kernels] flash_attention Sq > Sk {dtype}: unseen rows 0, the "
            f"rest scaled excess {ex:.3g}")
    # the tensor-core kernel takes D in {16, 32, 64, 128, 256}, refuses others
    q = _randn(torch, rng, (1, 64, 2, 96), torch.bfloat16)
    try:
        fa.flash_attention_fwd(q, q, q)
    except ValueError:
        log("[kernels] flash_attention bf16 D=96: refused (ValueError)")
    else:
        raise SmokeFailure("flash_attention bf16 D=96 was not refused")


# label, (B, T, H, G, P, N, chunk), dtype name, with an entry state; the
# first two are every mamba2-370m layer at the ssm phase's shape
SSD_CASES = (
    ("mamba2-370m layer", (4, 4096, 32, 1, 64, 128, 128), "bfloat16",
     False),
    ("mamba2-370m layer fp32", (4, 4096, 32, 1, 64, 128, 128), "float32",
     False),
    ("ragged B*H and chunk tail", (3, 1000, 5, 1, 64, 128, 128), "float32",
     True),
    ("groups, fp32", (2, 512, 8, 2, 32, 64, 64), "float32", False),
)


def check_ssd(torch, label, dims, dtype, with_h0, seed):
    """The SSD-scan kernel against its plain version (``ssd_scan_ref``
    over the flattened heads), per element (``TOL``; the fp32 state at the
    fp32 limits); returns the max abs error of y."""
    import numpy as np

    from repro_torch.kernels import ssd_scan as ssd

    B, T, H, G, P, N, chunk = dims
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)
    f32 = torch.float32
    x = _randn(torch, rng, (B, T, H, P), dt_, 0.5)
    dt = torch.nn.functional.softplus(_randn(torch, rng, (B, T, H), f32))
    A = -torch.exp(_randn(torch, rng, (H,), f32, 0.3))
    b = _randn(torch, rng, (B, T, G, N), dt_, 0.5)
    c = _randn(torch, rng, (B, T, G, N), dt_, 0.5)
    h0 = _randn(torch, rng, (B, H, P, N), f32, 0.5) if with_h0 else None
    y, h = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk, h0=h0)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, A, b, c, h0)
    torch.cuda.synchronize()
    rtol, atol = TOL["ssd_scan"][dtype]
    ey = excess(y, y_ref, rtol, SSD_Y_DIMS)
    eh = excess(h, h_ref, 2e-4, SSD_H_DIMS)
    err = max_err(y, y_ref)
    require(bool(torch.isfinite(y.float()).all()) and ey <= atol
            and eh <= 2e-4, f"ssd_scan {label}: scaled excess y {ey} "
            f"(rtol {rtol}, atol {atol}), h {eh} (2e-4, 2e-4)")
    log(f"[kernels] ssd_scan {label} {dims} {dtype}: y max abs err "
        f"{err:.3g}, scaled excess y {ey:.3g} (rtol {rtol}, atol {atol} x "
        f"the head's RMS), h {eh:.3g} (2e-4, 2e-4)")
    if label == "mamba2-370m layer":
        # the check rejects a kernel that drops the state carried into the
        # second chunk: the plain version restarted from zero there
        y_bad = y_ref.clone()
        y_bad[:, chunk:] = ssd.ssd_scan_plain(
            *(t[:, chunk:].contiguous() for t in (x, dt)), A,
            *(t[:, chunk:].contiguous() for t in (b, c)))[0]
        ex_bad = excess(y_bad, y_ref, rtol, SSD_Y_DIMS)
        require(ex_bad > atol, f"ssd_scan {label}: an output that drops "
                f"one chunk's carried state passes the check ({ex_bad})")
        log(f"[kernels] ssd_scan {label}: one carried state dropped would "
            f"give a scaled excess of {ex_bad:.3g}")
    return err


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
    rev_pinned = check_reverse_pinned(torch, cfg)
    adv_pinned = check_advance_pinned(torch, cfg)
    loop = check_step_loop(torch, cfg)
    # the new kernels; the error kept is that of the main path's shapes
    flash = [check_flash(torch, *case, seed=20 + i)
             for i, case in enumerate(FLASH_CASES)]
    check_flash_unseen_rows(torch)
    ssd = [check_ssd(torch, *case, seed=30 + i)
           for i, case in enumerate(SSD_CASES)]
    # the flash kernel's shapes on the main path: gemma2-2b's, phi3.5-moe's
    state["err"] = {"lstm_cell": max(errs["torch.float32"], loop),
                    "fused_advance_segment": max(adv, adv1, adv_pinned),
                    "fused_reverse_segment": max(rev, rev1, rev_pinned),
                    "flash_attention": max(flash[0], flash[2]),
                    "ssd_scan": ssd[0]}


def _dense_reference(torch, params, batch):
    from repro_torch.models.lstm import forward_loss

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = forward_loss(leaves, batch["tokens"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _check_against(label, loss, grads, ref_loss, ref_grads,
                   grad_limit=1e-4):
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    gerr = {k: scaled_err(grads[k], ref_grads[k]) for k in ref_grads}
    finite = all(bool(g.isfinite().all()) for g in grads.values())
    require(finite and math.isfinite(float(loss)),
            f"{label}: non-finite loss or gradients")
    require(all(grads[k].shape == ref_grads[k].shape for k in ref_grads),
            f"{label}: gradient shapes differ from the parameters'")
    require(rel <= 1e-5, f"{label}: loss rel err {rel} > 1e-5")
    worst = max(gerr.values())
    require(worst <= grad_limit,
            f"{label}: gradient scaled err {gerr} > {grad_limit}")
    return rel, worst


def _fused_counts():
    """The LSTM kernels' launch counters and kernel 1's step-loop counters
    by caller, now."""
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf

    launches = {"lstm_cell": lc.lstm_cell.launches,
                "fused_advance_segment": sf.fused_advance_segment.launches,
                "fused_reverse_segment": sf.fused_reverse_segment.launches}
    cells = {"advance": (sf.fused_advance_segment.cell_launches,
                         sf.fused_advance_segment.cell_steps),
             "reverse": (sf.fused_reverse_segment.cell_launches,
                         sf.fused_reverse_segment.cell_steps)}
    return launches, cells


def _check_fused_launches(label, before, plan, tune, stats):
    """Phase ``main``'s launch gates for one fused gradient: the fused
    advance once a segment and once a probe call, the reverse once a
    segment, and kernel 1's launches and steps by caller as the plan
    implies.  ``before``: :func:`_fused_counts` before the run."""
    now, cells_now = _fused_counts()
    grew = {k: now[k] - before[0][k] for k in now}
    cells = {k: (cells_now[k][0] - before[1][k][0],
                 cells_now[k][1] - before[1][k][1]) for k in cells_now}
    segs = plan.num_segments
    probe = tune.probe_calls   # one fused advance each
    require(grew["fused_advance_segment"] == segs + probe
            and grew["fused_reverse_segment"] == segs,
            f"{label}: fused launches {grew} for {segs} segments "
            f"(+{probe} probe launches)")
    require(stats.fused_segments == 2 * segs,
            f"{label}: stats.fused_segments {stats.fused_segments}")
    want = expected_cell_work(plan, tune)
    require(cells == want, f"{label}: kernel 1's launches and steps by "
            f"caller {cells}, the plan implies {want}")
    return grew, cells


def phase_main(state) -> None:
    import torch

    from repro_torch import api
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf

    lstm_inputs(state)
    model, params, batch = state["model"], state["params"], state["batch"]
    ref_loss, ref_grads = lstm_reference(params, batch, "main")
    state["lstm_ref"] = (ref_loss, ref_grads)

    for fn in (lc.lstm_cell, sf.fused_advance_segment,
               sf.fused_reverse_segment):
        fn.launches = 0
    lc.lstm_cell.steps = 0
    for fn in (sf.fused_advance_segment, sf.fused_reverse_segment):
        fn.cell_launches = fn.cell_steps = 0
    runs = []
    for label, kw in (("autotuned", {}), ("pinned", {"interval": 1000})):
        before = _fused_counts()
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
        grew, cells = _check_fused_launches(label, before, plan, tune, stats)
        segs = plan.num_segments
        log(f"[main] {label}: tune I={tune.interval} s={tune.slots} "
            f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); "
            f"plan {plan.plan_id} ({segs} segments)")
        log(f"[main] {label}: loss {float(loss):.6f} (rel err {rel:.3g}), "
            f"grad scaled err {gerr:.3g}; wall {wall:.3f}s; launches {grew}")
        log(f"[main] {label}: lstm_cell step loop by caller (launches, cell "
            f"steps): advance {cells['advance']}, reverse recompute "
            f"{cells['reverse']}")
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
    launches = _fused_counts()[0]
    for k, n in launches.items():
        require(n > 0, f"{k} was not launched on the main path")
    log(f"[main] lstm_cell: {launches['lstm_cell']} launches ran "
        f"{lc.lstm_cell.steps} cell steps (advance "
        f"{sf.fused_advance_segment.cell_launches} launches, "
        f"{sf.fused_advance_segment.cell_steps} steps; reverse recompute "
        f"{sf.fused_reverse_segment.cell_launches} launches, "
        f"{sf.fused_reverse_segment.cell_steps} steps)")
    state.setdefault("launches", {}).update(launches)
    state["lstm_steps"] = lc.lstm_cell.steps
    state["runs"] = runs


# chain length of phase strategies: train_4k's first half (at S=4096 the
# phase took 118-126 s on the card, over its ~90 s budget)
STRATEGIES_T = 2048


def phase_strategies(state) -> None:
    """Revolve, store-all and the interpreted multistage engine on
    ``lstm-paper`` at full width, each through the front door with the
    ``lstm_cell`` kernel once a chain step (see the module docstring)."""
    import torch

    from repro_torch import api
    from repro_torch.core import revolve as rv
    from repro_torch.kernels import lstm_cell as lc

    lstm_inputs(state)
    model, params = state["model"], state["params"]
    n = STRATEGIES_T
    batch = {"tokens": state["batch"]["tokens"][:, :n + 1].contiguous()}
    ref_loss, ref_grads = lstm_reference(params, batch, "strategies")
    slots = None
    for label, kw in (
            ("multistage, interpreted, I=256",
             {"engine": "interpreted", "interval": 256}),
            ("multistage, interpreted, autotuned", {"engine": "interpreted"}),
            ("revolve", {"strategy": "revolve"}),
            ("conventional", {"strategy": "conventional"})):
        if label == "revolve":
            kw["slots"] = slots   # one Level-1 budget, as Fig. 5 compares
        vg = api.value_and_grad_offloaded(model.train_loss, device="cuda",
                                          **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.lstm_cell.launches = 0
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lc.lstm_cell.launches
        l1_peak = torch.cuda.max_memory_allocated()
        tune, stats, plan = api.last_tune(), api.last_stats(), \
            api.last_plan()
        rel, gerr = _check_against(label, loss, grads, ref_loss, ref_grads)
        del loss, grads
        strategy = kw.get("strategy", "multistage_async")
        if strategy == "multistage_async":
            planned, fwd_steps = plan.total_advances(), 0
            if slots is None:   # the pinned run's
                slots = tune.slots
        elif strategy == "revolve":
            planned = rv.count_advances(rv.revolve_schedule(n, tune.slots))
            fwd_steps = n
        else:
            planned, fwd_steps = n, n
        probe = tune.probe_calls * tune.probe_len
        want = fwd_steps + stats.advances + stats.backwards + probe
        require(stats.advances == planned and stats.backwards == n,
                f"{label}: advances {stats.advances}, backwards "
                f"{stats.backwards}; the plan implies {planned} and {n}")
        require(launches == want and launches > 0,
                f"{label}: lstm_cell launched {launches} times, the stats "
                f"imply {want} ({fwd_steps} forward + {stats.advances} "
                f"advances + {stats.backwards} backwards + {probe} probe "
                "steps)")
        log(f"[strategies] {label}: tune I={tune.interval} s={tune.slots} "
            f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); "
            f"loss rel err {rel:.3g}, grad scaled err {gerr:.3g}")
        log(f"[strategies] {label}: advances={stats.advances} "
            f"backwards={stats.backwards} "
            f"recompute_factor={stats.recompute_factor:.4f} "
            f"peak_l1_states={stats.peak_l1_states} "
            f"host_dispatches={stats.host_dispatches} "
            f"l2_stores={stats.l2_stores} "
            f"l2_peak_bytes={stats.l2_peak_bytes} "
            f"wall_s={stats.wall_s:.3f} (call {wall:.3f}s) "
            f"l1_peak_device_bytes={l1_peak} "
            f"store_stall_s={stats.store_stall_s:.4f} "
            f"prefetch_stall_s={stats.prefetch_stall_s:.4f} "
            f"lstm_cell.launches={launches}")


class _SpyBackends:
    """Records the Level-2 backends the front door builds in its scope,
    so their counters can be read after a run (the run itself is not
    changed)."""

    def __enter__(self):
        from repro_torch.api import frontend as fe

        self._fe, self._real, self.made = fe, fe.make_backend, []

        def spy(kind, **kw):
            self.made.append(self._real(kind, **kw))
            return self.made[-1]

        fe.make_backend = spy
        return self

    def __exit__(self, *exc):
        self._fe.make_backend = self._real


def fs_type(path: str) -> str:
    """The filesystem type of ``path``: the longest mount point in
    ``/proc/mounts`` that contains it."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return f"{kind} (mounted at {best})"


def _host_allocator_stats(torch) -> str:
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "not exposed by this PyTorch"
    s = stats()
    keys = [k for k in ("allocated_bytes.current", "active_bytes.current",
                        "allocations.current", "active_requests.current",
                        "num_host_alloc", "num_host_free") if k in s]
    if not keys:
        keys = sorted(s)[:8]
    return ", ".join(f"{k}={s[k]}" for k in keys) or "no statistics"


# pinned interval and budgets (in boundary states) of phase level2's tiered
# runs: 16 boundaries of 524,292 B at train_4k
LEVEL2_I = 256
LEVEL2_BUDGETS = (16, 8, 1)
LEVEL2_AUTOTUNED_BUDGET = 64


def phase_level2(state) -> None:
    """The other Level-2 backends through the front door on ``lstm-paper``
    at ``train_4k`` (B=256, S=4096), ``runner="fused"``: (a) disk,
    autotuned; (b) tiered at I=256 with budgets of 16, 8 and 1 boundary
    states, after host RAM at the same I; (c) tiered, autotuned, 64
    states; (d) int8-compressed, autotuned.  Each under phase ``main``'s gates (compressed: each leaf
    within the reference's 5e-2 of its scale) and launch counts; the slow
    tier lives in a directory under the out-dir, removed afterwards."""
    import shutil

    import torch

    from repro_torch import api
    from repro_torch.core import perfmodel
    from repro_torch.core.storage import tree_bytes

    lstm_inputs(state)
    model, params, batch = state["model"], state["params"], state["batch"]
    if "lstm_ref" not in state:
        state["lstm_ref"] = lstm_reference(params, batch, "level2")
    ref_loss, ref_grads = state["lstm_ref"]
    n = batch["tokens"].shape[1] - 1
    carry0, _ = model.train_loss.chain_spec.prelude(params, batch)
    sb = tree_bytes(carry0)
    directory = os.path.join(state["out_dir"], "level2")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    ram = state.get("runs")
    log(f"[level2] slow tier in {directory}: filesystem "
        f"{fs_type(directory)}; no fsync, so a disk figure is the page "
        f"cache's; boundary state {sb} B"
        + (f"; the RAM run (phase main, autotuned): wall "
           f"{ram[0]['wall_s']:.3f}s, I={ram[0]['interval']}" if ram
           else ""))

    before_path = _fused_counts()
    runs = []
    cases = [("disk, autotuned", {"storage": "disk"}),
             (f"ram I={LEVEL2_I} (the tiered runs' baseline)",
              {"storage": "ram", "interval": LEVEL2_I})]
    cases += [(f"tiered I={LEVEL2_I}, {k} states",
               {"storage": "tiered", "interval": LEVEL2_I,
                "l2_capacity_bytes": k * sb}) for k in LEVEL2_BUDGETS]
    cases += [(f"tiered, autotuned, {LEVEL2_AUTOTUNED_BUDGET} states",
               {"storage": "tiered",
                "l2_capacity_bytes": LEVEL2_AUTOTUNED_BUDGET * sb}),
              ("compressed, autotuned", {"storage": "compressed"})]
    for label, kw in cases:
        storage = kw["storage"]
        vg = api.value_and_grad_offloaded(
            model.train_loss, runner="fused", device="cuda",
            storage_dir=directory if storage in ("disk", "tiered")
            else None,
            **kw)
        before = _fused_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _SpyBackends() as spy:
            t0 = time.perf_counter()
            loss, grads = vg(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        l1_peak = torch.cuda.max_memory_allocated()
        tune, stats, plan = api.last_tune(), api.last_stats(), \
            api.last_plan()
        require(len(spy.made) == 1, f"{label}: {len(spy.made)} backends")
        backend = spy.made[0]
        limit = 5e-2 if storage == "compressed" else 1e-4
        rel, gerr = _check_against(label, loss, grads, ref_loss, ref_grads,
                                   grad_limit=limit)
        grew, _ = _check_fused_launches(label, before, plan, tune, stats)
        segs = plan.num_segments
        leftover = [f for f in os.listdir(directory) if f.startswith("ckpt_")]
        require(not leftover and backend.live_bytes == 0,
                f"{label}: {leftover} left in {directory}, live bytes "
                f"{backend.live_bytes}")
        if storage == "tiered":
            cap = kw["l2_capacity_bytes"]
            tier = plan.tier_plan(cap, sb)
            model_peak = perfmodel.fast_peak_bytes_model(
                n, plan.interval, sb, cap)
            require(stats.l2_fast_peak_bytes == model_peak <= cap
                    and stats.l2_evictions == tier.spilled
                    and stats.prefetch_depth == tier.prefetch_distance,
                    f"{label}: fast peak {stats.l2_fast_peak_bytes} (model "
                    f"{model_peak}, cap {cap}), evictions "
                    f"{stats.l2_evictions} (plan {tier.spilled}), prefetch "
                    f"depth {stats.prefetch_depth} (plan "
                    f"{tier.prefetch_distance})")
            if tune.source == "measured":
                require(tune.t_t_slow > 0 and tune.capacity_bytes == cap,
                        f"{label}: t_t_slow {tune.t_t_slow}, capacity "
                        f"{tune.capacity_bytes}")
                if math.ceil(n / tune.interval) * sb > cap:
                    require(tune.interval * tune.t_a
                            >= min(tune.t_t, tune.t_t_slow),
                            f"{label}: I={tune.interval} does not hide "
                            "the cheaper tier's transfer")
        if storage == "compressed":
            ratio = backend.bytes_written / backend.raw_bytes
            require(ratio < 0.5, f"{label}: bytes written {ratio:.3f} of "
                    "the raw bytes")
            errs = {k: f"{scaled_err(grads[k], ref_grads[k]):.3g}"
                    for k in ref_grads}
            log(f"[level2] {label}: per-leaf grad scaled err {errs} (limit "
                f"5e-2, the reference's); bytes written "
                f"{backend.bytes_written} of raw {backend.raw_bytes} "
                f"({ratio:.4f})")
        log(f"[level2] {label}: T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s "
            f"T_T_slow={tune.t_t_slow:.6e}s I={tune.interval} "
            f"({tune.source}); {segs} segments; wall {wall:.3f}s; loss rel "
            f"err {rel:.3g}, grad scaled err {gerr:.3g}; launches {grew}")
        log(f"[level2] {label}: l1_peak_device_bytes={l1_peak} "
            f"l2_peak_bytes={stats.l2_peak_bytes} "
            f"l2_fast_peak_bytes={stats.l2_fast_peak_bytes} "
            f"evictions={stats.l2_evictions} "
            f"promotions={stats.l2_promotions} "
            f"prefetch_depth={stats.prefetch_depth} "
            f"l2_staged_peak_bytes={stats.l2_staged_peak_bytes} "
            f"store_stall_s={stats.store_stall_s:.4f} "
            f"prefetch_stall_s={stats.prefetch_stall_s:.4f}")
        if storage == "tiered":
            log(f"[level2] {label}: page-locked host allocator "
                f"{_host_allocator_stats(torch)}")
        runs.append({"label": label, "interval": tune.interval,
                     "segments": segs, "wall_s": wall, "l1_peak": l1_peak})
        del loss, grads, vg
    shutil.rmtree(directory)
    launches = {k: v - before_path[0][k]
                for k, v in _fused_counts()[0].items()}
    for k, c in launches.items():
        require(c > 0, f"{k} was not launched in phase level2")
    log(f"[level2] launches in this phase: {launches}")
    state["level2"] = runs


# pinned interval of phase resume (16 segments of train_4k) and its tiered
# run's fast-tier budget in boundary states
RESUME_I = 256
RESUME_TIER_STATES = 8
RESUME_BUDGET_S = 90.0   # the crash loops' time budget


class _JournalMeter:
    """Reads each journaled run's WAL size and commit barriers
    (``fdatasync`` calls) just before ``end_run`` compacts the file — the
    bytes the run wrote and the barriers it paid — and the barriers after
    the compaction.  The run itself is not changed."""

    def __enter__(self):
        from repro_torch.core.storage import JournaledStorage

        self._cls, self._real = JournaledStorage, JournaledStorage.end_run
        self.runs = []
        real = self._real

        def end_run(js):
            before = (js.journal_bytes, js.fsync_count)
            real(js)
            self.runs.append({"bytes": before[0], "barriers": before[1],
                              "barriers_after_compaction": js.fsync_count})

        JournaledStorage.end_run = end_run
        return self

    def __exit__(self, *exc):
        self._cls.end_run = self._real


def _barrier_costs(directory):
    """Milliseconds of one commit barrier (``fdatasync``) on the WAL's
    filesystem after appending a boundary-sized record (524,292 B) and
    after a 64-byte one, each the mean of 20."""
    from repro_torch.core import journal

    path = os.path.join(directory, "barrier.log")
    out = {}
    for label, size in (("524292 B", 524292), ("64 B", 64)):
        jf = journal.JournalFile(path)
        payload = os.urandom(size)
        total = 0.0
        for _ in range(20):
            jf.append(journal.OP_STORE, b"k", payload, sync=False)
            t0 = time.perf_counter()
            jf.flush()
            total += time.perf_counter() - t0
        jf.close()
        os.remove(path)
        out[label] = 1e3 * total / 20
    return out


def _read_journal(jd):
    """The last epoch of the WAL in ``jd`` read without opening it as a
    store (which would truncate a torn tail): its surviving keys, last
    cursor and whether the file ends in damage."""
    import pickle

    from repro_torch.core import journal

    jf = journal.JournalFile(os.path.join(jd, "wal.log"))
    try:
        scan = jf.scan()
    finally:
        jf.close()
    keys, cursor = {}, None
    for rec in journal.iter_epoch(scan.records):
        if rec.op == journal.OP_BEGIN:
            keys, cursor = {}, None
        elif rec.op == journal.OP_STORE:
            keys[rec.key] = None
        elif rec.op == journal.OP_DELETE:
            keys.pop(rec.key, None)
        elif rec.op == journal.OP_CURSOR:
            cursor = pickle.loads(rec.payload)
    return tuple(keys), cursor, scan.damage


class _RecoverMeter:
    """Keeps what each ``JournaledStorage.recover()`` returns while it is
    entered: the resume's own view of the journal it opened."""

    def __enter__(self):
        from repro_torch.core.storage import JournaledStorage

        self._cls, self._real = JournaledStorage, JournaledStorage.recover
        self.runs = []
        real = self._real

        def recover(js):
            rec = real(js)
            self.runs.append(rec)
            return rec

        JournaledStorage.recover = recover
        return self

    def __exit__(self, *exc):
        self._cls.recover = self._real


def _resume_expectation(plan, jd):
    """What resuming the journal in ``jd`` must do under ``plan``: the
    segments it advances (from the end of the contiguous durable prefix;
    none after a reverse-phase crash), those it reverses, the
    ``replayed_advances`` the cursor attests, and kernel 1's (launches,
    steps) by caller.  The WAL is read as it lies, damage included."""
    from repro_torch.core.schedule import chunk_length
    from repro_torch.kernels import segment_fused as sf

    keys, cur, damage = _read_journal(jd)
    segs = plan.segments
    if cur is not None and cur.phase == "reverse":
        advanced, reversed_, replayed = [], segs[:cur.segment_index + 1], 0
    else:
        start = -1
        for seg in segs:
            if seg.begin in keys:
                start = seg.sid
            else:
                break
        b_star = segs[start].begin if start >= 0 else 0
        replayed = 0
        if start >= 0 and cur is not None:
            replayed = max(0, plan.cursor_position(cur) - b_star)
        advanced, reversed_ = segs[max(start, 0):], segs
    cells = {"advance": [0, 0], "reverse": [0, 0]}
    for group, caller in ((advanced, "advance"), (reversed_, "reverse")):
        for seg in group:
            w = sf.cell_work(seg.length, chunk_length(seg.length, plan.s_l1)
                             or seg.length)[caller]
            cells[caller][0] += w[0]
            cells[caller][1] += w[1]
    return {"advanced": len(advanced), "reversed": len(reversed_),
            "replayed": replayed,
            "torn": damage is not None and damage.kind == "torn",
            "cursor": None if cur is None else (cur.phase,
                                                cur.segment_index),
            "cells": {k: tuple(v) for k, v in cells.items()}}


def _pick(indices, all_fit: bool):
    return list(indices) if all_fit else sorted(
        {indices[0], indices[len(indices) // 2], indices[-1]})


def phase_resume(state) -> None:
    """Crash consistency on ``lstm-paper`` at ``train_4k`` (B=256, S=4096),
    ``runner="fused"``, I=256, with the write-ahead journal in a directory
    under the out-dir: a fault-free journaled gradient (phase ``main``'s
    gates, launch counts, and bit for bit the unjournaled run at the same
    I); a writer kill at every forward store and a failed fetch at every
    reverse fetch, each resumed with ``resume_offloaded`` (bit for bit the
    fault-free run, ``replayed_advances <= I``, launches as the journal
    implies); a torn record; a flipped byte (``ChecksumError``, then
    ``journal_repair=True``); a journaled tiered run at 8 states;
    autotuned gradients, unjournaled and journaled, with deterministic
    algorithms off and on.  Deterministic algorithms are on for the rest of
    the phase (``CUBLAS_WORKSPACE_CONFIG`` is set at start-up)."""
    import itertools
    import shutil

    import torch
    import torch.utils.deterministic as det_fill

    from repro_torch import api
    from repro_torch.core import faults, perfmodel
    from repro_torch.core.faults import ChecksumError, FaultPlan
    from repro_torch.core.storage import tree_bytes
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf

    lstm_inputs(state)
    model, params, batch = state["model"], state["params"], state["batch"]
    if "lstm_ref" not in state:
        state["lstm_ref"] = lstm_reference(params, batch, "resume")
    ref_loss, ref_grads = state["lstm_ref"]
    n = batch["tokens"].shape[1] - 1
    carry0, _ = model.train_loss.chain_spec.prelude(params, batch)
    sb = tree_bytes(carry0)
    directory = os.path.join(state["out_dir"], "resume")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    barrier = _barrier_costs(directory)
    log(f"[resume] WAL in {directory}: filesystem {fs_type(directory)}; "
        f"boundary state {sb} B; one commit barrier (fdatasync) after a "
        + ", after a ".join(f"{k} append: {v:.3f} ms"
                            for k, v in barrier.items()))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    kw = {"runner": "fused", "device": "cuda", "interval": RESUME_I}
    counter = itertools.count()

    def run(vg_kw, plan=None, repair=None):
        """One gradient (a resume when ``repair`` is not None), under the
        fault ``plan`` if one is given, with its wall; raises what the run
        raises."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if repair is None:
            vg = api.value_and_grad_offloaded(model.train_loss, **vg_kw)
            if plan is None:
                out = vg(params, batch)
            else:
                with faults.inject(plan):
                    out = vg(params, batch)
        else:
            out = api.resume_offloaded(model.train_loss, params, batch,
                                       repair=repair, **vg_kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def bit_equal(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in b[1])

    def fresh_dir():
        return os.path.join(directory, f"wal{next(counter)}")

    try:
        # this phase's path: every count from 0 here, read at its end
        for fn in (lc.lstm_cell, sf.fused_advance_segment,
                   sf.fused_reverse_segment):
            fn.launches = 0
        lc.lstm_cell.steps = 0
        for fn in (sf.fused_advance_segment, sf.fused_reverse_segment):
            fn.cell_launches = fn.cell_steps = 0
        # (a) unjournaled and journaled, fault-free, in turns
        walls = {"plain": [], "journaled": []}
        meters = []
        ref_out = None   # the first unjournaled run's loss and gradients
        for label in ("plain", "journaled", "journaled", "plain"):
            vg_kw = dict(kw)
            before = _fused_counts()
            if label == "journaled":
                vg_kw["journal_dir"] = fresh_dir()
                with _JournalMeter() as meter:
                    out, wall = run(vg_kw)
                require(len(meter.runs) == 1,
                        f"{len(meter.runs)} journaled runs ended")
                meters.append(meter.runs[0])
            else:
                out, wall = run(vg_kw)
            tune, stats, plan = api.last_tune(), api.last_stats(), \
                api.last_plan()
            _check_against(f"resume {label}", out[0], out[1], ref_loss,
                           ref_grads)
            _check_fused_launches(f"resume {label}", before, plan, tune,
                                  stats)
            walls[label].append(wall)
            if ref_out is None:
                ref_out = out
            require(bit_equal(out, ref_out),
                    f"resume {label}: not bit for bit the unjournaled run")
            require(stats.replayed_advances == 0
                    and stats.l2_stores == plan.num_segments
                    + (label == "journaled"),
                    f"resume {label}: stores {stats.l2_stores}, replayed "
                    f"{stats.replayed_advances}")
        segs = plan.num_segments
        log(f"[resume] I={RESUME_I}, {segs} segments: wall unjournaled "
            f"{walls['plain'][0]:.3f}, {walls['plain'][1]:.3f} s; journaled "
            f"{walls['journaled'][0]:.3f}, {walls['journaled'][1]:.3f} s; "
            f"journal bytes {meters[0]['bytes']}, {meters[1]['bytes']}; "
            f"barriers {meters[0]['barriers']}, {meters[1]['barriers']} "
            f"({meters[0]['barriers_after_compaction']} after the "
            "end-of-run compaction); bit for bit the unjournaled run")
        # (b) a writer kill at every forward store, a failed fetch at every
        # reverse fetch, each resumed
        kills, gets = list(range(segs + 1)), list(range(segs))
        estimate = 2 * (len(kills) + len(gets)) * max(walls["journaled"])
        all_fit = estimate <= RESUME_BUDGET_S
        picked = [("kill", k) for k in _pick(kills, all_fit)] + \
            [("get", j) for j in _pick(gets, all_fit)]
        log(f"[resume] crash loops: {len(picked)} crashes "
            + ("(every forward store and reverse fetch)" if all_fit else
               f"(first, middle and last of each: the whole loop was "
               f"estimated at {estimate:.0f} s, over {RESUME_BUDGET_S:.0f})"))
        results = []
        for what, at in picked:
            plan_f = FaultPlan(kill_writer_at_store=at) if what == "kill" \
                else FaultPlan(fail_get_at=at)
            jd = fresh_dir()
            vg_kw = dict(kw, journal_dir=jd)
            try:
                run(vg_kw, plan=plan_f)
                raise SmokeFailure(f"resume {what} {at}: the run completed")
            except SmokeFailure:
                raise
            except Exception as e:
                require(faults.is_storage_fault(e),
                        f"resume {what} {at}: untyped failure {e!r}")
            want = _resume_expectation(plan, jd)
            before = _fused_counts()
            out, wall = run(vg_kw, repair=False)
            stats = api.last_stats()
            now, cells_now = _fused_counts()
            grew = {k: now[k] - before[0][k] for k in now}
            cells = {k: (cells_now[k][0] - before[1][k][0],
                         cells_now[k][1] - before[1][k][1])
                     for k in cells_now}
            require(bit_equal(out, ref_out),
                    f"resume {what} {at}: not bit for bit the fault-free run")
            require(stats.replayed_advances == want["replayed"] <= RESUME_I,
                    f"resume {what} {at}: replayed {stats.replayed_advances}"
                    f", the journal implies {want['replayed']}")
            require(grew["fused_advance_segment"] == want["advanced"]
                    and grew["fused_reverse_segment"] == want["reversed"]
                    and cells == want["cells"],
                    f"resume {what} {at}: launches {grew}, cells {cells}; "
                    f"the journal implies {want}")
            results.append(f"{what}{at}: cursor {want['cursor']}, advanced "
                           f"{want['advanced']}, reversed {want['reversed']},"
                           f" replayed {stats.replayed_advances}, resume "
                           f"{wall:.3f}s")
            shutil.rmtree(jd)
        log("[resume] every resume bit for bit the fault-free run: "
            + "; ".join(results))
        # (c) a torn STORE record, then a flipped byte
        mid = segs // 2
        jd = fresh_dir()
        vg_kw = dict(kw, journal_dir=jd)
        try:
            run(vg_kw, plan=FaultPlan(truncate_journal_at_store=mid))
            raise SmokeFailure("resume torn: the run completed")
        except SmokeFailure:
            raise
        except Exception as e:
            require(faults.is_storage_fault(e), f"resume torn: {e!r}")
        want = _resume_expectation(plan, jd)
        with _RecoverMeter() as seen:
            out, wall = run(vg_kw, repair=False)
        stats = api.last_stats()
        require(want["torn"] and len(seen.runs) == 1 and seen.runs[0].torn
                and bit_equal(out, ref_out)
                and stats.replayed_advances == want["replayed"] <= RESUME_I,
                f"resume torn: {want}, the resume's recovery "
                f"{[r.torn for r in seen.runs]}, replayed "
                f"{stats.replayed_advances}")
        log(f"[resume] torn STORE record {mid}: the resume discarded the "
            "tail on open, "
            f"cursor {want['cursor']}, replayed {stats.replayed_advances}, "
            f"resume {wall:.3f}s, bit for bit")
        shutil.rmtree(jd)
        jd = fresh_dir()
        vg_kw = dict(kw, journal_dir=jd)
        try:
            run(vg_kw, plan=FaultPlan(flip_byte_at_store=mid,
                                              kill_writer_at_store=mid + 1))
            raise SmokeFailure("resume flip: the run completed")
        except SmokeFailure:
            raise
        except Exception as e:
            require(faults.is_storage_fault(e), f"resume flip: {e!r}")
        try:
            run(vg_kw, repair=False)
            raise SmokeFailure("resume flip: no ChecksumError on open")
        except ChecksumError:
            pass
        out, wall = run(vg_kw, repair=True)
        stats = api.last_stats()
        require(bit_equal(out, ref_out)
                and stats.replayed_advances <= RESUME_I,
                f"resume flip: replayed {stats.replayed_advances}")
        log(f"[resume] flipped byte in STORE record {mid}: ChecksumError on "
            f"open; journal_repair=True replayed {stats.replayed_advances}, "
            f"resume {wall:.3f}s, bit for bit")
        shutil.rmtree(jd)
        # (d) journaled over a tiered store at 8 states
        cap = RESUME_TIER_STATES * sb
        vg_kw = dict(kw, journal_dir=fresh_dir(), storage="tiered",
                     storage_dir=os.path.join(directory, "slow"),
                     l2_capacity_bytes=cap)
        before = _fused_counts()
        out, wall = run(vg_kw)
        tune, stats, plan = api.last_tune(), api.last_stats(), \
            api.last_plan()
        _check_fused_launches("resume tiered", before, plan, tune, stats)
        tier = plan.tier_plan(cap, sb)
        model_peak = perfmodel.fast_peak_bytes_model(n, plan.interval, sb,
                                                     cap)
        # the journaled final state, a key outside the plan, is evicted
        # once more (as in the JAX package)
        require(bit_equal(out, ref_out)
                and stats.l2_fast_peak_bytes == model_peak <= cap
                and stats.l2_evictions == tier.spilled + 1
                and stats.l2_promotions == tier.spilled
                and stats.prefetch_depth == tier.prefetch_distance,
                f"resume tiered: fast peak {stats.l2_fast_peak_bytes} "
                f"(model {model_peak}), evictions {stats.l2_evictions} / "
                f"promotions {stats.l2_promotions} (plan {tier.spilled}), "
                f"depth {stats.prefetch_depth} "
                f"(plan {tier.prefetch_distance})")
        log(f"[resume] journaled tiered, {RESUME_TIER_STATES} states: wall "
            f"{wall:.3f}s; fast peak {stats.l2_fast_peak_bytes}, evictions "
            f"{stats.l2_evictions} (the plan's {tier.spilled} + the final "
            f"state), promotions {stats.l2_promotions}, depth "
            f"{stats.prefetch_depth} (= the plan); bit for bit")
        # (e) autotuned gradients, each with a tuner of its own (a fresh
        # probe): unjournaled and journaled in turns with deterministic
        # algorithms off, then journaled with them on, and on without
        # filling new allocations; held to phase main's gates, not bits
        modes = [("plain", False, True), ("journaled", False, True),
                 ("journaled", False, True), ("plain", False, True),
                 ("journaled", True, True), ("journaled", True, False)]
        autotuned = []
        for label, det, fill in modes:
            vg_kw = {"runner": "fused", "device": "cuda",
                     "tuner": api.AutoTuner()}
            if label == "journaled":
                vg_kw["journal_dir"] = fresh_dir()
            torch.use_deterministic_algorithms(det, warn_only=True)
            det_fill.fill_uninitialized_memory = fill
            before = _fused_counts()
            try:
                with _JournalMeter() as meter:
                    out, wall = run(vg_kw)
            finally:
                torch.use_deterministic_algorithms(True, warn_only=True)
                det_fill.fill_uninitialized_memory = True
            tune, stats, plan = api.last_tune(), api.last_stats(), \
                api.last_plan()
            mode = (f"{label}, deterministic "
                    + ("off" if not det else "on" if fill
                       else "on without filling new allocations"))
            rel, gerr = _check_against(f"resume autotuned {mode}", out[0],
                                       out[1], ref_loss, ref_grads)
            _check_fused_launches(f"resume autotuned {mode}", before, plan,
                                  tune, stats)
            wal = meter.runs[0] if meter.runs else {"bytes": 0,
                                                    "barriers": 0}
            autotuned.append({"mode": mode, "t_a": tune.t_a,
                              "t_t": tune.t_t, "interval": tune.interval,
                              "segments": plan.num_segments, "wall": wall,
                              **wal})
            log(f"[resume] autotuned, {mode}: T_A={tune.t_a:.6e}s "
                f"T_T={tune.t_t:.6e}s I={tune.interval} ({tune.source}), "
                f"{plan.num_segments} segments; wall {wall:.3f}s; journal "
                f"bytes {wal['bytes']}, barriers {wal['barriers']}; loss "
                f"rel err {rel:.3g}, grad scaled err {gerr:.3g}; "
                f"store_stall_s {stats.store_stall_s:.4f} prefetch_stall_s "
                f"{stats.prefetch_stall_s:.4f}")
        state["resume"] = {"walls": walls, "meters": meters,
                           "autotuned": autotuned}
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(directory, ignore_errors=True)
    launches = _fused_counts()[0]
    for k, c in launches.items():
        require(c > 0, f"{k} was not launched in phase resume")
    log(f"[resume] launches in this phase: {launches}")


def lstm_inputs(state) -> None:
    """``lstm-paper`` at ``train_4k`` with seeded weights, into ``state``
    (once)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.convert import init_lstm_numpy, params_from_numpy
    from repro_torch.models.model_factory import get_model

    if "params" in state:
        return
    cfg = get_config("lstm-paper")
    state.update(cfg=cfg, model=get_model(cfg),
                 batch=make_batch(cfg, SHAPES["train_4k"], seed=0),
                 params=params_from_numpy(init_lstm_numpy(
                     0, cfg.vocab, cfg.d_model, cfg.d_ff)))


def lstm_reference(params, batch, phase: str):
    """Dense autograd of ``forward_loss`` (the plain cell), timed."""
    import torch

    t0 = time.perf_counter()
    ref_loss, ref_grads = _dense_reference(torch, params, batch)
    torch.cuda.synchronize()
    log(f"[{phase}] dense autograd reference over "
        f"{batch['tokens'].shape[1] - 1} steps: loss {float(ref_loss):.6f} "
        f"in {time.perf_counter() - t0:.2f}s")
    return ref_loss, ref_grads


def expected_cell_work(plan, tune):
    """Kernel 1's step-loop (launches, steps) by caller that one offloaded
    LSTM gradient implies: per segment what ``segment_fused.cell_work``
    counts at the runner's chunk, and one advance of ``probe_len`` steps
    (one chunk) per autotune probe call."""
    from repro_torch.core.schedule import chunk_length
    from repro_torch.kernels import segment_fused as sf

    want = {"advance": [0, 0], "reverse": [0, 0]}
    work = [sf.cell_work(seg.length,
                         chunk_length(seg.length, plan.s_l1) or seg.length)
            for seg in plan.segments]
    work += [{"advance": (1, tune.probe_len)}] * tune.probe_calls
    for w in work:
        for k, (n, steps) in w.items():
            want[k][0] += n
            want[k][1] += steps
    return {k: tuple(v) for k, v in want.items()}


def _tree_value_and_grad(torch, loss_fn, params, batch):
    """Dense ``torch.autograd`` of ``loss_fn`` over every parameter leaf."""
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _to_host(torch, tensors):
    """Page-locked host copies of ``tensors`` (a decoder's reference
    gradients while the offloaded calls run, so that the card never holds
    two gradient trees)."""
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.append(h.copy_(t, non_blocking=True))
    torch.cuda.synchronize()
    return out


class _RoutingRecorder:
    """Each MoE layer's top-k choices (the indices ``moe._route`` returns),
    by layer: the layer is the one whose router weight the call was given.
    ``mode = "reference"`` records them (dense autograd's forward);
    ``mode = "check"`` counts the choices that differ from the recorded
    ones (the offloaded forward sweep, probe and recompute); ``None``
    ignores the calls."""

    def __init__(self, params, cfg):
        from repro_torch.models.transformer import _periods

        self.routers = [lp[f"pos{j}"]["moe"]["router"]["w"].detach()
                        for lp in _periods(params["layers"])
                        for j, kind in enumerate(cfg.layer_pattern)
                        if kind.endswith("_moe")]
        self.reference, self.mode = {}, None
        self.calls, self.compared, self.flips = 0, 0, 0

    def _layer(self, w):
        import torch

        for i, r in enumerate(self.routers):
            if w.data_ptr() == r.data_ptr() or (
                    w.shape == r.shape and torch.equal(w, r)):
                return i
        raise SmokeFailure("routing recorder: a router weight of no layer")

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe._route

        def recorded(p, xg, n_experts, top_k):
            out = route(p, xg, n_experts, top_k)
            if self.mode is not None:
                i = self._layer(p["router"]["w"].detach())
                idx = out[1].detach()
                self.calls += 1
                if self.mode == "reference":
                    self.reference[i] = idx.clone()
                else:
                    self.compared += idx.numel()
                    self.flips += int((idx != self.reference[i]).sum())
            return out

        moe._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._route


def decoder_phase(state, key: str, arch: str, batch_size: int, kernels,
                  per_step, revolve_slots=None, tiered_states=None,
                  n_layers=None) -> None:
    """The offloaded gradient of a decoder (``runner="compiled"``,
    autotuned) at full width, ``train_4k`` with the global batch cut to
    ``batch_size`` and, with ``n_layers``, the depth cut to that many
    layers; held against dense autograd of ``train_loss``, whose gradients
    wait on the host (page-locked) while the offloaded calls run.
    ``kernels``: name -> wrapper; ``per_step``: launches of each per chain
    step advanced (forward sweep, autotune probe and the reverse's
    recompute alike).  A MoE model's routing in the offloaded call (forward
    sweep, probe, recompute) must equal the reference forward's, choice
    for choice.  With ``revolve_slots``, also one ``strategy="revolve"``
    gradient with that many Level-1 slots; with ``tiered_states``, one
    ``storage="tiered"`` gradient at I=1 whose fast tier holds that many
    boundary states."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.models.model_factory import get_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    full = SHAPES["train_4k"]
    shape = ShapeSpec(full.name, full.seq_len, batch_size, full.kind)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = make_batch(cfg, shape, seed=0)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def dense():
        return _tree_value_and_grad(torch, model.train_loss, params, batch)

    routing = _RoutingRecorder(params, cfg) if cfg.moe else None
    with routing or contextlib.nullcontext():
        # the first call pays for the allocator's growth and library
        # set-up; the second is the reference and its time
        first, dense_cold = timed(dense)
        del first
        torch.cuda.reset_peak_memory_stats()
        if routing:
            routing.mode = "reference"
        (ref_loss, ref_grads), dense_wall = timed(dense)
        dense_peak = torch.cuda.max_memory_allocated()
        ref_grads = _to_host(torch, ref_grads)
        log(f"[{key}] {arch}: {cfg.n_layers} layers, {n_params:,} "
            f"parameters, B={batch_size} S={shape.seq_len}; dense autograd "
            f"reference: loss {float(ref_loss):.6f} in {dense_wall:.3f}s "
            f"(first call {dense_cold:.3f}s), device peak {dense_peak:,} B"
            "; its gradients moved to page-locked host memory")

        vg = api.value_and_grad_offloaded(model.train_loss, device="cuda")
        for fn in kernels.values():
            fn.launches = 0
        if routing:
            routing.mode, routing.calls = "check", 0
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), wall = timed(lambda: vg(params, batch))
        launches = {k: fn.launches for k, fn in kernels.items()}
        l1_peak = torch.cuda.max_memory_allocated()
        if routing:
            routing.mode = None
    tune, stats, plan = api.last_tune(), api.last_stats(), api.last_plan()
    if routing:
        require(routing.flips == 0 and routing.calls > 0,
                f"{key}: {routing.flips} of {routing.compared} routing "
                "choices of the offloaded call differ from the reference "
                "forward's")
        log(f"[{key}] routing: {routing.calls} MoE layer applications in "
            f"the offloaded call (forward, probe, recompute), "
            f"{routing.compared} top-{cfg.moe.top_k} choices, "
            f"{routing.flips} differ from the reference forward's")

    grads = pytree.tree_leaves(grads)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(math.isfinite(float(loss))
            and all(bool(g.isfinite().all()) for g in grads),
            f"{key}: non-finite loss or gradients")
    require([g.shape for g in grads] == [g.shape for g in ref_grads],
            f"{key}: gradient shapes differ from the parameters'")
    gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
    require(rel <= 1e-5, f"{key}: loss rel err {rel} > 1e-5")
    require(gerr <= 1e-3, f"{key}: gradient scaled err {gerr} > 1e-3")
    probe = tune.probe_calls * tune.probe_len   # chain steps the probe ran
    for name, n in launches.items():
        want = per_step[name] * (stats.advances + probe)
        require(n == want and n > 0,
                f"{key}: {name} launched {n} times, expected {want} "
                f"({per_step[name]} per step x ({stats.advances} advances "
                f"+ {probe} probe steps))")
    log(f"[{key}] tune I={tune.interval} s={tune.slots} "
        f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); plan "
        f"{plan.plan_id} ({plan.num_segments} segments of n={plan.n})")
    log(f"[{key}] offloaded: loss {float(loss):.6f} (rel err {rel:.3g}), "
        f"grad scaled err {gerr:.3g}; wall {wall:.3f}s; launches "
        f"{launches} (forward, probe and the reverse's recompute)")
    del grads, loss
    # a second and a third call: the schedule is cached (no probe); with
    # the caching allocator's retries (a cudaMalloc that failed, so cached
    # blocks were freed and the malloc retried) and its device mallocs
    warm_walls, alloc = [], []
    for _ in range(2):
        for fn in kernels.values():
            fn.launches = 0
        m0 = torch.cuda.memory_stats()
        (loss, grads), w = timed(lambda: vg(params, batch))
        m1 = torch.cuda.memory_stats()
        warm_walls.append(w)
        alloc.append(tuple(m1.get(k, 0) - m0.get(k, 0) for k in
                           ("num_alloc_retries", "num_device_alloc")))
        per_grad = {k: fn.launches for k, fn in kernels.items()}
        for name, n in per_grad.items():
            require(api.last_tune().probe_calls == 0
                    and n == per_step[name] * api.last_stats().advances,
                    f"{key}: {name} launched {n} times in a warm call")
        del grads, loss
    warm = warm_walls[0]
    log(f"[{key}] offloaded, second call: wall {warm:.3f}s "
        f"({warm / dense_wall:.3f}x dense autograd), third call "
        f"{warm_walls[1]:.3f}s ({warm_walls[1] / dense_wall:.3f}x); "
        f"allocator retries, device mallocs: {alloc[0]}, {alloc[1]}; "
        f"launches {per_grad} per gradient")
    log(f"[{key}] stats advances={stats.advances} "
        f"backwards={stats.backwards} l2_stores={stats.l2_stores} "
        f"host_dispatches={stats.host_dispatches} "
        f"l2_peak_bytes={stats.l2_peak_bytes} "
        f"l1_peak_device_bytes={l1_peak} "
        f"store_stall_s={stats.store_stall_s:.4f} "
        f"prefetch_stall_s={stats.prefetch_stall_s:.4f}")
    # a kernel on several phases' paths: its launches in all of them
    total = state.setdefault("launches", {})
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    state.setdefault("launches_by_phase", {})[key] = launches
    if state.get("profile"):   # the schedule is cached: no probe
        profile_call(state, key, f"{arch} I={tune.interval}",
                     lambda: vg(params, batch))
    if revolve_slots is not None:
        decoder_revolve(key, model, params, batch, ref_loss, ref_grads,
                        kernels, per_step, revolve_slots)
    if tiered_states is not None:
        decoder_tiered(state, key, model, params, batch, ref_loss, ref_grads,
                       kernels, per_step, tiered_states)
    state[key] = {"arch": arch, "B": batch_size, "S": shape.seq_len,
                  "interval": tune.interval, "slots": tune.slots,
                  "segments": plan.num_segments, "wall_s": wall,
                  "warm_wall_s": warm, "third_wall_s": warm_walls[1],
                  "dense_wall_s": dense_wall,
                  "dense_peak": dense_peak,
                  "l1_peak": l1_peak, "l2_peak": stats.l2_peak_bytes,
                  "loss_rel": rel, "grad_err": gerr, "cfg": cfg}
    del params, ref_grads, vg
    torch.cuda.empty_cache()


def decoder_revolve(key, model, params, batch, ref_loss, ref_grads, kernels,
                    per_step, slots) -> None:
    """One ``strategy="revolve"`` gradient of a decoder under its phase's
    gates; each kernel launched ``per_step`` times a chain step run: the
    forward sweep to ``x_n``, each advance and each backward's recompute."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.core import revolve as rv

    vg = api.value_and_grad_offloaded(model.train_loss, strategy="revolve",
                                      slots=slots, device="cuda")
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    l1_peak = torch.cuda.max_memory_allocated()
    stats = api.last_stats()
    n = stats.n
    grads = pytree.tree_leaves(grads)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(math.isfinite(float(loss))
            and all(bool(g.isfinite().all()) for g in grads),
            f"{key} revolve: non-finite loss or gradients")
    gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
    require(rel <= 1e-5, f"{key} revolve: loss rel err {rel} > 1e-5")
    require(gerr <= 1e-3, f"{key} revolve: gradient scaled err {gerr} > 1e-3")
    planned = rv.count_advances(rv.revolve_schedule(n, slots))
    require(stats.advances == planned and stats.backwards == n
            and stats.peak_l1_states <= slots,
            f"{key} revolve: advances {stats.advances} (plan {planned}), "
            f"backwards {stats.backwards}, peak_l1_states "
            f"{stats.peak_l1_states}")
    for name, got in launches.items():
        want = per_step[name] * (n + stats.advances + stats.backwards)
        require(got == want and got > 0,
                f"{key} revolve: {name} launched {got} times, expected "
                f"{want}")
    log(f"[{key}] revolve s={slots}: loss rel err {rel:.3g}, grad scaled "
        f"err {gerr:.3g}; wall {wall:.3f}s; advances={stats.advances} "
        f"backwards={stats.backwards} "
        f"recompute_factor={stats.recompute_factor:.4f} "
        f"peak_l1_states={stats.peak_l1_states} "
        f"host_dispatches={stats.host_dispatches} "
        f"l1_peak_device_bytes={l1_peak}; launches {launches}")


def decoder_tiered(state, key, model, params, batch, ref_loss, ref_grads,
                   kernels, per_step, states) -> None:
    """One ``storage="tiered"`` gradient of a decoder at I=1 with a fast
    tier of ``states`` boundary states over a disk slow tier under the
    out-dir, under its phase's gates: the fast peak equals
    ``fast_peak_bytes_model``, the evictions the plan's spills, each
    kernel ``per_step`` launches a step advanced.  First, the boundary
    itself (bf16) goes through a one-state tier and back to the card: the
    spilled copy, read from disk, is bit for bit the stored one."""
    import shutil

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.core import perfmodel
    from repro_torch.core.storage import (AsyncTransferEngine, TieredStorage,
                                          tree_bytes)

    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    directory = os.path.join(state["out_dir"], f"{key}_level2")
    shutil.rmtree(directory, ignore_errors=True)
    with torch.no_grad():
        carry0, _ = model.train_loss.chain_spec.prelude(params, batch)
    sb = tree_bytes(carry0)
    eng = AsyncTransferEngine(TieredStorage(sb, directory=directory),
                              device="cuda")
    eng.store_async(0, carry0)
    eng.store_async(1, carry0)   # spills key 0 to disk
    eng.wait_stores()
    require(eng.backend.evictions == 1, f"{key}: the one-state tier did not "
            "spill")
    for k in (0, 1):
        eng.prefetch_async(k)
        got = eng.wait_prefetch(k)
        for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(carry0)):
            require(a.dtype == b.dtype and torch.equal(
                a.view(bits[a.dtype]), b.view(bits[b.dtype])),
                f"{key}: boundary {k} ({a.dtype}) did not round-trip bit "
                "for bit")
        eng.delete(k)
    eng.close()
    del carry0, got
    log(f"[{key}] tiered: a {sb} B boundary (bf16 hidden state and f32 "
        f"aux) spilled to disk ({fs_type(directory)}) and promoted back to "
        "the card bit for bit")

    cap = states * sb
    vg = api.value_and_grad_offloaded(model.train_loss, storage="tiered",
                                      l2_capacity_bytes=cap,
                                      storage_dir=directory, interval=1,
                                      device="cuda")
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    l1_peak = torch.cuda.max_memory_allocated()
    stats, plan = api.last_stats(), api.last_plan()
    grads = pytree.tree_leaves(grads)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(math.isfinite(float(loss))
            and all(bool(g.isfinite().all()) for g in grads),
            f"{key} tiered: non-finite loss or gradients")
    gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
    require(rel <= 1e-5, f"{key} tiered: loss rel err {rel} > 1e-5")
    require(gerr <= 1e-3, f"{key} tiered: gradient scaled err {gerr} > 1e-3")
    tier = plan.tier_plan(cap, sb)
    model_peak = perfmodel.fast_peak_bytes_model(stats.n, 1, sb, cap)
    require(stats.l2_fast_peak_bytes == model_peak <= cap
            and stats.l2_evictions == tier.spilled
            and stats.prefetch_depth == tier.prefetch_distance,
            f"{key} tiered: fast peak {stats.l2_fast_peak_bytes} (model "
            f"{model_peak}), evictions {stats.l2_evictions} (plan "
            f"{tier.spilled}), prefetch depth {stats.prefetch_depth}")
    for name, got in launches.items():
        want = per_step[name] * stats.advances
        require(got == want and got > 0,
                f"{key} tiered: {name} launched {got} times, expected "
                f"{want}")
    require(not os.listdir(directory), f"{key} tiered: files left in "
            f"{directory}")
    shutil.rmtree(directory)
    log(f"[{key}] tiered I=1, {states} states ({cap} B): loss rel err "
        f"{rel:.3g}, grad scaled err {gerr:.3g}; wall {wall:.3f}s; "
        f"{plan.num_segments} segments; l1_peak_device_bytes={l1_peak} "
        f"l2_peak_bytes={stats.l2_peak_bytes} "
        f"l2_fast_peak_bytes={stats.l2_fast_peak_bytes} "
        f"evictions={stats.l2_evictions} promotions={stats.l2_promotions} "
        f"prefetch_depth={stats.prefetch_depth} "
        f"store_stall_s={stats.store_stall_s:.4f} "
        f"prefetch_stall_s={stats.prefetch_stall_s:.4f}; launches "
        f"{launches}; page-locked host allocator "
        f"{_host_allocator_stats(torch)}")


def phase_dense(state) -> None:
    from repro_torch.kernels import flash_attention as fa

    # every layer of gemma2-2b's (local, global) period is attention
    decoder_phase(state, "dense", "gemma2-2b", 2,
                  {"flash_attention": fa.flash_attention},
                  {"flash_attention": 2}, revolve_slots=4, tiered_states=4)


def phase_ssm(state) -> None:
    from repro_torch.kernels import ssd_scan as ssd

    decoder_phase(state, "ssm", "mamba2-370m", 4, {"ssd_scan": ssd.ssd_scan},
                  {"ssd_scan": 1})


# phi3.5-moe-42b's depth in phase moe: its fp32 parameters are 1.30 B a
# layer (5.2 GB), and dense autograd holds them, their gradients and every
# layer's activations (with the bf16 copies of the expert weights it saves)
MOE_LAYERS = 4


def phase_moe(state) -> None:
    from repro_torch.kernels import flash_attention as fa

    # one attn_moe layer a period: one flash launch a chain step
    decoder_phase(state, "moe", "phi3.5-moe-42b", 2,
                  {"flash_attention": fa.flash_attention},
                  {"flash_attention": 1}, n_layers=MOE_LAYERS)


def _cudnn_lstm(torch, w, b, Dx):
    """cuDNN's multi-step LSTM (``torch.nn.LSTM``, i.e. ``torch._VF.lstm``
    on its flattened weights) computing the chain's cell: gates re-laid out
    i, f, g, o, the +1 forget bias folded into b_ih; TF32 off as phase
    ``device`` sets it."""
    Dh = w.shape[1] // 4
    perm = torch.cat([torch.arange(0, 2 * Dh), torch.arange(3 * Dh, 4 * Dh),
                      torch.arange(2 * Dh, 3 * Dh)]).cuda()   # i, f, g, o
    rnn = torch.nn.LSTM(Dx, Dh).cuda()
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(w[:Dx, perm].t())
        rnn.weight_hh_l0.copy_(w[Dx:, perm].t())
        bias = b[perm].clone()
        bias[Dh:2 * Dh] += 1.0
        rnn.bias_ih_l0.copy_(bias)
        rnn.bias_hh_l0.zero_()
    rnn.flatten_parameters()
    return rnn


def _time_step_loop(torch, cfg, single_ms, single_bound_ms):
    """The step loop over one recompute chunk of the pinned run (B=256, L =
    its chunk), per launch and per step, against cuDNN's multi-step LSTM
    (``_cudnn_lstm``) on the same inputs, x = emb[tok] gathered
    beforehand."""
    from repro_torch.kernels import lstm_cell as lc

    L = pinned_chunk()
    params, (h0, c0, _), (tok, _), _ = _segment_case(torch, cfg, L, seed=7)
    emb, w, b = params["emb"], params["w"], params["b"]
    B, Dh = h0.shape
    Dx = emb.shape[1]
    hs = torch.empty((L + 1, B, Dh), device="cuda")
    cs = torch.empty_like(hs)
    hs[0], cs[0] = h0, c0
    xh = torch.empty((L, B, Dx + Dh), device="cuda")
    acts = torch.empty((L, B, 4 * Dh), device="cuda")
    bar = torch.empty((-(-B // 16),), dtype=torch.int32, device="cuda")
    ms_loop = cuda_ms(lambda: lc.lstm_cell_token_steps(
        tok, emb, hs, cs, w, b, xh=xh, acts=acts, barrier=bar), 20)
    rnn = _cudnn_lstm(torch, w, b, Dx)
    xin = emb[tok.long()]
    with torch.no_grad():
        out, _ = rnn(xin, (h0[None], c0[None]))
        torch.cuda.synchronize()
        err = max_err(out, hs[1:])
        require(err <= 1e-4, f"cuDNN LSTM yardstick off the step loop: {err}")
        ms_lib = cuda_ms(lambda: rnn(xin, (h0[None], c0[None])), 20)
    log(f"[timing] lstm_cell step loop over a recompute chunk (L={L}, B={B}"
        f", one launch): {ms_loop:.4f} ms per launch, "
        f"{1e3 * ms_loop / L:.3f} us per step (single step "
        f"{1e3 * single_ms:.3f} us; bound {1e3 * single_bound_ms:.3f} us a "
        f"step); cuDNN multi-step LSTM (nn.LSTM) {ms_lib:.4f} ms, "
        f"{1e3 * ms_lib / L:.3f} us per step (max abs diff of the states "
        f"{err:.3g})")


def _time_segment_kernels(torch, cfg, T, slots, detail=False):
    """Fused advance/reverse and their plain versions timed over one
    full-width segment of T steps chunked as the runner chunks it, with the
    least time the card could take for the same work; both by part, and
    with ``detail`` also the advance's boundary writes and its library
    composite."""
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
    ms_p = cuda_ms(lambda: sf.advance_plain(lstm.plain_body, params, carry,
                                            xs, None, chunk=chunk), iters)
    nc = len(sf.forward_bounds(T, chunk)) - 1
    pbytes = 4.0 * (V * Dx + K * 4 * Dh + 4 * Dh + Dh * V + V)
    step_flops = cell_flops(B, Dx, Dh) + 2.0 * B * Dh * V + 4.0 * B * V
    nbytes = pbytes + 8.0 * T * B + 4.0 * (2 * (2 * B * Dh + 1)
                                            + nc * (2 * B * Dh + 1))
    out["fused_advance_segment"] = (ms_k, ms_p) + bound_ms(nbytes,
                                                           T * step_flops)
    out["flops"] = {"fused_advance_segment": T * step_flops}
    iters = max(1, min(50, 1000 // T))
    ms_k = cuda_ms(lambda: sf.fused_reverse_segment(
        body, (False, False), params, carry, xs, None, dcarry, chunk=chunk),
        iters)
    ms_p = cuda_ms(lambda: sf.reverse_plain(
        lstm.plain_body, (False, False), params, carry, xs, None, dcarry,
        chunk=chunk), iters)
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
    flops = recompute * cell_flops(B, Dx, Dh) + T * back
    out["fused_reverse_segment"] = (ms_k, ms_p) + bound_ms(nbytes, flops)
    out["flops"]["fused_reverse_segment"] = flops
    out["parts"] = _parts(torch, lambda: sf.fused_reverse_segment(
        body, (False, False), params, carry, xs, None, dcarry, chunk=chunk),
        REVERSE_PARTS)
    out["advance_parts"] = _parts(torch, lambda: sf.fused_advance_segment(
        body, params, carry, xs, None, chunk=chunk), ADVANCE_PARTS)
    if detail:
        out["writes"] = _time_boundary_writes(torch, params, carry, xs, chunk)
        _time_advance_composite(torch, body, params, carry, xs, chunk)
    return out


def _time_boundary_writes(torch, params, carry, xs, chunk):
    """Milliseconds of one forward chunk's readout and loss kernels
    (``lstm_adv_chunk``, after its step loop), with the chunk-entry
    boundary written into page-locked host memory through its device
    mapping, as the advance does, and into device memory instead: what the
    writes across the bus cost.  Timed in turns: host, device, device,
    host."""
    from repro_torch.kernels import build
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import segment_fused as sf

    lib = sf._seg_lib()
    (h0, c0, _), (tok, tgt) = carry, xs
    B, Dh = h0.shape
    V, L = params["w_out"].shape[1], chunk
    hs = torch.empty((L + 1, B, Dh), device="cuda")
    cs = torch.empty_like(hs)
    lc.lstm_cell_token_steps(tok[:L], params["emb"], hs, cs, params["w"],
                             params["b"], entry=(h0, c0))
    lg = torch.empty((L * B, V), device="cuda")
    msum = torch.empty((L,), device="cuda")
    nxt = (torch.empty_like(h0), torch.empty_like(c0))
    dests = {"host": [torch.empty((B, Dh), pin_memory=True)
                      for _ in range(2)],
             "device": [torch.empty((B, Dh), device="cuda")
                        for _ in range(2)]}
    ptr, stream = build.ptr, build.stream_ptr()

    def call(bh, bc):
        err = lib.lstm_adv_chunk(
            ptr(params["w_out"]), ptr(params["b_out"]), V, Dh, ptr(tgt),
            ptr(hs), ptr(cs), L, B, ptr(lg), ptr(msum), ptr(h0), ptr(c0),
            ptr(bh), ptr(bc), ptr(nxt[0]), ptr(nxt[1]), stream)
        build.check(lib, err, "lstm_adv_chunk")

    ms = {"host": [], "device": []}
    for where in ("host", "device", "device", "host"):
        ms[where].append(cuda_ms(lambda: call(*dests[where]), 50))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _time_advance_composite(torch, body, params, carry, xs, chunk):
    """A composite of three library calls computing what the fused advance
    computes over the segment (without its boundary copies): cuDNN's
    multi-step LSTM (``_cudnn_lstm``), then ``F.linear`` and
    ``F.cross_entropy`` over its T B rows; x = emb[tok] gathered and the
    targets widened beforehand.  Checked against the advance (final h 1e-4,
    the loss sum 1e-4 relative), then timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import segment_fused as sf

    emb, w_out, b_out = params["emb"], params["w_out"], params["b_out"]
    (h0, c0, acc0), (tok, tgt) = carry, xs
    T, V = tok.shape[0], w_out.shape[1]
    rnn = _cudnn_lstm(torch, params["w"], params["b"], emb.shape[1])
    xin, gold = emb[tok.long()], tgt.reshape(-1).long()

    def composite():
        out, (hn, _) = rnn(xin, (h0[None], c0[None]))
        logits = F.linear(out, w_out.t(), b_out)
        return hn[0], F.cross_entropy(logits.reshape(-1, V), gold)

    with torch.no_grad():
        hn, loss = composite()
        adv = sf.fused_advance_segment(body, params, carry, xs, None,
                                       chunk=chunk)
        torch.cuda.synchronize()
        herr = max_err(hn, adv.carry[0])
        # the advance adds the T step means: T times the mean over all rows
        ref = float(adv.carry[2]) - float(acc0)
        lrel = abs(T * float(loss) - ref) / abs(ref)
        require(herr <= 1e-4 and lrel <= 1e-4,
                f"library composite off the fused advance: h {herr}, loss "
                f"sum rel {lrel}")
        ms = cuda_ms(composite, 3)
    log(f"[timing] fused_advance_segment yardstick, a composite of library "
        f"calls (not one call): cuDNN nn.LSTM over T={T} + F.linear + "
        f"F.cross_entropy: {ms:.4f} ms (against the advance: h {herr:.3g}, "
        f"loss sum rel {lrel:.3g})")


# A segment kernel's parts by kernel name; a reduce_kernel adds the slices
# of the product launched just before it, so it joins that product's part.
REVERSE_PARTS = (("lstm_cell_kernel", "recompute"),
                 ("dlogits_kernel", "hoisted"),
                 ("gemm_kernel<false", "hoisted"),
                 ("walk_kernel", "walk"),
                 ("gemm_kernel<true", "reductions"),
                 ("embed_grad_kernel", "reductions"),
                 ("add_kernel", "reductions"))
ADVANCE_PARTS = (("lstm_cell_kernel", "step loop"),
                 ("gemm_kernel", "readout"),
                 ("advance_loss_kernel", "loss and boundaries"),
                 ("acc_finalize_kernel", "finalize"))


def _parts(torch, call, table):
    """Device milliseconds of one ``call()`` of a fused segment kernel by
    part (``table``; copies and anything unnamed under "other"), from
    ``torch.profiler``'s kernel events in launch order; None if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                    for e in _device_events(prof) if e.name not in CALLERS)
    parts, last = {}, "other"
    for _, us, name in events:
        part = next((p for key, p in table if key in name), None)
        if part is None:
            part = last if "reduce_kernel" in name else "other"
        parts[part] = parts.get(part, 0.0) + us / 1e3
        last = part
    return parts or None


def _time_flash(torch, run):
    """Kernel 4 at a decoder phase's attention shape (``run``: every
    gemma2-2b layer, whose local layers' window of 4096 spans the whole
    sequence, or every phi3.5-moe layer), its plain version, and
    ``scaled_dot_product_attention`` on K/V repeated per group: the same
    function at phi3.5-moe's shape, gemma2-2b's without its softcap (no
    library call computes that)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    cfg = run["cfg"]
    B, S, H, G, D = run["B"], run["S"], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(40)
    bf16 = torch.bfloat16
    q = _randn(torch, rng, (B, S, H, D), bf16)
    k = _randn(torch, rng, (B, S, G, D), bf16)
    v = _randn(torch, rng, (B, S, G, D), bf16)
    kw = {"softcap": cfg.attn_softcap, "scale": cfg.query_scale}
    same = cfg.attn_softcap is None
    ms_k = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), 5)
    ms_p = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=cfg.query_scale), 5)
    # causal: S (S + 1) / 2 (query, key) pairs per head, 2 products each
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2.0 * (2 * B * S * H * D + 2 * B * S * G * D) + 4.0 * B * H * S
    b_ms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
    log(f"[timing] flash_attention at {cfg.name}'s B={B} S={S} H={H} G={G} "
        f"D={D} bf16 (softcap {cfg.attn_softcap}): {ms_k:.4f} ms, "
        f"{flops / ms_k / 1e9:.1f} TFLOP/s (plain {ms_p:.4f} ms; bound "
        f"{b_ms:.4f} ms by {by}; library {ms_l:.4f} ms, "
        f"{flops / ms_l / 1e9:.1f} TFLOP/s: scaled_dot_product_attention on "
        "K/V repeated per group, "
        + ("the same function)" if same else "which lacks the softcap)"))
    return ("flash_attention", "src/repro_torch/kernels/csrc/"
            "flash_attention.cu", "src/repro/kernels/flash_attention.py:86",
            ms_k, ms_p, b_ms, by, ms_l, flops)


def _time_ssd(torch, run):
    """Kernel 5 at the ssm phase's shape (every mamba2-370m layer) and its
    plain version; no library call computes the SSD scan."""
    import numpy as np

    from repro_torch.kernels import ssd_scan as ssd

    cfg = run["cfg"]
    s = cfg.ssm
    B, T = run["B"], run["S"]
    H, G, P, N, L = (s.expand * cfg.d_model // s.headdim, s.ngroups,
                     s.headdim, s.d_state, s.chunk)
    rng = np.random.default_rng(41)
    bf16, f32 = torch.bfloat16, torch.float32
    x = _randn(torch, rng, (B, T, H, P), bf16, 0.5)
    dt = torch.nn.functional.softplus(_randn(torch, rng, (B, T, H), f32))
    A = -torch.exp(_randn(torch, rng, (H,), f32, 0.3))
    b = _randn(torch, rng, (B, T, G, N), bf16, 0.5)
    c = _randn(torch, rng, (B, T, G, N), bf16, 0.5)
    ms_k = cuda_ms(lambda: ssd.ssd_scan(x, dt, A, b, c, chunk=L), 10)
    ms_p = cuda_ms(lambda: ssd.ssd_scan_plain(x, dt, A, b, c), 1)
    from torch.profiler import ProfilerActivity, profile

    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ssd.ssd_scan(x, dt, A, b, c, chunk=L)
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        key = next((k for k in ("ssd_decay", "ssd_state", "ssd_pass",
                                "ssd_out") if k in e.key), None)
        if key is not None and us:
            passes[key] = passes.get(key, 0.0) + us / 1e3 / calls
    log("[timing] ssd_scan by pass (device ms per call, torch.profiler over "
        f"{calls} calls): "
        + (", ".join(f"{k} {v:.4f}" for k, v in passes.items())
           or "not measured (the profiler saw no device time)"))
    # per (batch*head, chunk of L): C B^T and M xbar over the causal
    # L (L + 1) / 2 pairs, C h^T and the state update over L x P x N
    n_chunks = B * H * (T // L)
    flops = n_chunks * (L * (L + 1) * (N + P) + 4.0 * L * P * N)
    nbytes = (2.0 * (2 * B * T * H * P + 2 * B * T * G * N)
              + 4.0 * (B * T * H + H + B * H * P * N))
    b_ms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
    log(f"[timing] ssd_scan at B={B} T={T} H={H} G={G} P={P} N={N} "
        f"chunk={L} bf16")
    return ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan.py:69", ms_k, ms_p, b_ms, by, None,
            flops)


def log_parts(name, T, parts) -> None:
    log("[timing] {} at T={} by part (one call, device time of its kernels, "
        "torch.profiler): {}".format(
            name, T, "not measured (the profiler saw no device time)"
            if parts is None else ", ".join(f"{k} {v:.4f} ms"
                                             for k, v in parts.items())))


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
                 ms_l, cell_flops(B, Dx, Dh)))
    _time_step_loop(torch, cfg, ms_k, bms)

    # kernels 2 and 3 at the autotuned main path's segment shape
    run = state["runs"][0]
    seg = _time_segment_kernels(torch, cfg, run["interval"], run["slots"])
    for name, line in (("fused_advance_segment", "482"),
                       ("fused_reverse_segment", "495")):
        k_ms, p_ms, b_ms, by = seg[name]
        rows.append((name, "src/repro_torch/kernels/csrc/segment_fused.cu",
                     f"src/repro/kernels/segment_pallas.py:{line}", k_ms,
                     p_ms, b_ms, by, None, seg["flops"][name]))
    # at T=2, the shortest segment the autotuner picks (its pick before the
    # advance was redesigned), when it picked another
    if seg["T"] != 2:
        short = _time_segment_kernels(torch, cfg, 2, run["slots"])
        for name in ("fused_advance_segment", "fused_reverse_segment"):
            log(f"[timing] {name} at T=2: {short[name][0]:.4f} ms (bound "
                f"{short[name][2]:.4f} ms)")
        log_parts("fused_advance_segment", 2, short["advance_parts"])
    # and at the pinned run's segment shape (long segments, 16 chunks)
    pinned = state["runs"][1]
    long_seg = _time_segment_kernels(torch, cfg, pinned["interval"],
                                     pinned["slots"], detail=True)
    for name in ("fused_advance_segment", "fused_reverse_segment"):
        k_ms, p_ms, b_ms, by = long_seg[name]
        tflops = long_seg["flops"][name] / k_ms / 1e9
        log(f"[timing] {name} at T={long_seg['T']} chunk="
            f"{long_seg['chunk']}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {by}; {tflops:.2f} TFLOP/s fp32)")
    for name, key in (("fused_reverse_segment", "parts"),
                      ("fused_advance_segment", "advance_parts")):
        log_parts(name, long_seg["T"], long_seg[key])
    writes = long_seg["writes"]
    log(f"[timing] fused_advance_segment: one chunk's readout and loss "
        f"kernels (L={long_seg['chunk']}) with the chunk-entry boundary "
        f"written to page-locked host memory {writes['host']:.4f} ms, to "
        f"device memory {writes['device']:.4f} ms")

    flash = {k: _time_flash(torch, state[k]) for k in ("dense", "moe")
             if k in state}
    # the row at phi3.5-moe's shape, where the library call computes the
    # same function; launches: every decoder phase's offloaded first call
    rows.append(flash["moe"] if "moe" in flash else flash["dense"])
    by_phase = {k: v["flash_attention"]
                for k, v in state["launches_by_phase"].items()
                if "flash_attention" in v}
    log(f"[timing] flash_attention launches by phase: {by_phase}")
    rows.append(_time_ssd(torch, state["ssm"]))

    out = []
    for name, src, rep, k_ms, p_ms, b_ms, by, l_ms, flops in rows:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": state["launches"][name],
                    "max_abs_err": state["err"][name], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": l_ms})
        log(f"[timing] {name}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by}, library "
            f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}; "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s); launches "
            f"{state['launches'][name]}")
    log(f"[timing] LSTM segment shape: T={seg['T']} chunk={seg['chunk']} "
        f"B={B}; bounds: LSTM kernels at the fp32 peak (67 TFLOP/s), "
        f"flash_attention and ssd_scan at the bf16 tensor-core peak "
        f"(989 TFLOP/s), bytes at 3.35 TB/s ({state['card']})")
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


def profile_call(state, label: str, note: str, call) -> None:
    """Run ``call()`` (one warmed-up offloaded gradient) under
    ``torch.profiler``: device time by kernel against the wall, the table
    to ``<out-dir>/profile_<label>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(state["out_dir"], exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.key in CALLERS:   # a range's device span, not a kernel
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    callers = by_caller(prof)
    path = os.path.join(state["out_dir"], f"profile_{label}.txt")
    with open(path, "w") as f:
        f.write(f"# {state['card']}; one offloaded gradient, {note}; wall "
                f"{wall:.6f} s\n")
        for name, (n, span_ms, cell_ms, all_ms) in callers.items():
            f.write(f"# {name} ({n} calls): device span {span_ms:.3f} ms, "
                    f"kernels in it {all_ms:.3f} ms, lstm_cell_kernel "
                    f"{cell_ms:.3f} ms\n")
        f.write("# device_us\tcount\tname\n")
        for us, count, key in rows:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
    if not rows:
        log(f"[profile] {label}: the profiler saw no device time (device "
            "busy share not measured)")
        return
    log(f"[profile] {label} ({note}): wall {wall:.4f}s, device busy "
        f"{busy_s:.4f}s ({100 * busy_s / wall:.1f}% of the wall); table "
        f"{path}")
    for us, count, key in rows[:6]:
        log(f"[profile]   {us / 1e3:10.3f} ms  x{count:<6d} {key[:70]}")
    for name, (n, span_ms, cell_ms, all_ms) in callers.items():
        log(f"[profile]   {name} ({n} calls): device span {span_ms:.3f} ms,"
            f" kernels in it {all_ms:.3f} ms, lstm_cell_kernel "
            f"{cell_ms:.3f} ms")


# the fused segment wrappers' profiler ranges (segment_fused._card_call)
CALLERS = ("fused_advance_segment", "fused_reverse_segment")


def _device_events(prof):
    return [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def by_caller(prof):
    """Per fused segment wrapper: its calls, the device span of its profiler
    range (the profiler records a range on the device too, from the start of
    the first kernel launched in it to the end of the last), and the device
    milliseconds of the kernels that start within those spans, all and
    kernel 1's (``lstm_cell_kernel``); copies (on their own streams) are
    left out.  The segment kernels run in order on one stream, so the spans
    do not overlap."""
    import bisect

    dev = _device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name in CALLERS)
    starts = [sp[0] for sp in spans]
    acc = {}
    for lo, hi, name in spans:
        n, span, cell, total = acc.get(name, (0, 0.0, 0.0, 0.0))
        acc[name] = (n + 1, span + (hi - lo) / 1e3, cell, total)
    for e in dev:
        if e.name in CALLERS or e.name.startswith(("Memcpy", "Memset")):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= spans[i][1]:
            continue
        name = spans[i][2]
        ms = e.time_range.elapsed_us() / 1e3
        n, span, cell, total = acc[name]
        acc[name] = (n, span, cell + (ms if "lstm_cell_kernel" in e.name
                                      else 0.0), total + ms)
    return acc


def phase_profile(state) -> None:
    """Where one offloaded LSTM gradient's time goes, per schedule of the
    main phase (the decoder phases profile themselves when ``profile`` is
    among the phases)."""
    from repro_torch import api

    if "runs" not in state:   # phase main did not run
        return
    model, params, batch = state["model"], state["params"], state["batch"]
    for run in state["runs"]:
        kw = {"interval": run["interval"]} if run["label"] == "pinned" \
            else {}
        vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                          device="cuda", **kw)
        vg(params, batch)   # warm: the schedule is cached, kernels loaded
        profile_call(state, run["label"], f"I={run['interval']}",
                     lambda: vg(params, batch))


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

    if "resume" in phases:
        # bit-identical resume on the card: cuBLAS reads this when its
        # first handle is made (phase resume turns on deterministic
        # algorithms for itself)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    state = {"out_dir": os.path.abspath(args.out_dir),
             "profile": "profile" in phases}
    steps = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "main": phase_main,
             "strategies": phase_strategies, "level2": phase_level2,
             "resume": phase_resume,
             "dense": phase_dense, "ssm": phase_ssm, "moe": phase_moe,
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

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
              bf16 flash forward and backward and SSD kernels, which must
              contain them; the layer kernels' registers and spills from
              the ptxas report.
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
              must be refused.  The generic fused segments' kernels bit
              for bit against their plain versions: ``entry_store`` at
              gemma2-2b's and mamba2-370m's carries, a 0-d fp32 leaf, a
              bf16 leaf of odd length and a misaligned leaf, into
              page-locked slots; ``fold`` at gemma2-2b's main-path reverse
              chunk (4 chain steps of weight cotangents copied into their
              rows, the unread parameters' broadcast zeros skipped) and at
              a synthetic case with fp32, bf16, mixed and fresh adds.
              The layer kernels of gemma2-2b's body against their plain
              versions (``GRAD_TOL``, the scaled error over the plain
              version's max |value|): ``flash_attention_bwd`` (dq, dk, dv
              at gemma2-2b's attn_local and attn layers and phi3.5-moe's,
              bf16 3e-2 and fp32 2e-4, on the flash forward's ``out`` and
              ``lse``; ``FLASH_CASES``' smaller cases; two calls bit for
              bit; bf16 D=96 refused), ``rmsnorm`` (with and without the
              residual), ``glu`` (GeGLU and SwiGLU) and ``rope`` (q and k
              in one launch), forward and backward at gemma2-2b's shapes,
              bf16 3e-2 and fp32 1e-5, each two calls bit for bit.
              The kernels of mamba2-370m's body: ``ssd_scan_bwd`` (every
              leaf per element at ``TOL["ssd_scan"]``, at the layer shape in
              bf16 and a small fp32 shape with groups and an entry state;
              two calls bit for bit; a backward that drops the cotangent
              carried from chunk 1 into chunk 0 fails that check),
              ``causal_conv``, ``dt_softplus`` and ``gated_norm``, forward
              and backward, at the layer shape in bf16 and a small fp32
              shape (``MAMBA_TOL``: elementwise per element against the
              row's RMS, the sums over rows by their scaled error), two
              calls bit for bit.  The projections' GEMM (``dense_fwd``,
              ``dense_bwd``'s dx and dw; ``check_dense``) at every
              projection of both bodies (``DENSE_CASES``: x, dy bf16, w
              the fp32 parameter cast in the load) and at a ragged fp32
              shape with w fp32 and bf16, per element (``DENSE_TOL``)
              against the plain version on cuBLAS with fp32 reductions,
              two calls bit for bit; a dw without its last 32 rows must
              fail that gate.  The MoE layer's kernels (``check_moe``) at
              phi3.5-moe's layer (``MOE_LAYER``: 2 groups of 4096 tokens,
              d 4096 bf16, 16 experts top-2): the routing (probs and
              weights 1e-5, dx and dW_r by ``MOE_TOL``; a choice may
              differ from the plain version's only at a near-tie of its
              probs, ``ROUTE_TIE``, logged), and at capacity factors 1.25
              and 0.25 (experts overflow) the slots equal, the dispatch and
              its vjp bit for bit, the combine and its vjp (``MOE_TOL``);
              the experts' products batched (gate/up and down) at
              ``DENSE_TOL``; every kernel two calls bit for bit.
4. main     — ``value_and_grad_offloaded(get_model(lstm-paper).train_loss,
              runner="fused")`` on ``make_batch(lstm-paper, train_4k)``
              (B=256, S=4096), once autotuned and once with a pinned
              interval that leaves a tail segment, each held against dense
              ``torch.autograd`` of ``forward_loss`` (loss at 1e-5
              relative, each gradient leaf at 1e-4 of its max |g|); the LSTM
              kernels' launch counts are read from this phase alone, kernel
              1's launches and steps also by caller (the advance's chunks,
              the reverse's recompute), each held to what the plan implies.
              The fused segments run captured (one CUDA graph replay per
              segment and direction, ``segment_fused.CapturedRun``); each
              schedule then takes three warm calls in turns, captured,
              uncaptured (``segment_fused._CAPTURED`` off: the wrappers
              that allocate per call) and captured again: bit for bit the
              same loss and gradients, the same plan, counters and launch
              counts, no graph captured again, and no page-locked host
              allocation or device malloc in a warm captured call.
5. scan     — the same ``lstm-paper`` gradient through ``engine="scan"``
              (one autograd graph, an autograd function a segment whose
              entry carry goes to page-locked host memory), autotuned and
              pinned at I=64 (``SCAN_I``), each held to phase ``main``'s
              gates against that phase's fused gradient; ``last_plan()``
              equal to ``segment_plan(n, I, s)``, one page-locked boundary
              a segment (``api.last_scan()``), ``lstm_cell`` launched once
              a chain step run (forward, recompute, probe); a warm call
              of the autotuned schedule; the device peak at S=4096 against
              S=2048 (the same tokens' first half) at I=64 must grow less
              than 1 MB per 1,000 steps.
6. strategies — the paper's baselines and its step-granular interpreter on
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
7. level2   — the other Level-2 backends through the front door on
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
8. resume   — crash consistency on ``lstm-paper`` at ``train_4k``,
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
9. dense    — first ``tied_table_check`` (gemma2-2b's tied table's
              gradient, summed in the head's buffer, bit for bit
              autograd's sum at full size); then
              ``value_and_grad_offloaded(get_model(gemma2-2b).train_loss)``
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
              Then one ``engine="scan"`` run (autotuned) under the same
              gates (its plan, one page-locked boundary a segment,
              ``flash_attention`` twice a chain step run: forward,
              recompute, probe), one ``strategy="revolve"`` run (4 slots)
              under the same gates, ``flash_attention`` launched twice a
              step as above, and
              one ``storage="tiered"`` run at I=1 with a fast tier of 4
              boundary states over disk (fast peak and evictions as the
              model and plan say; a bf16 boundary spilled and promoted
              back bit for bit).  And 2D plans at the first call's
              interval: the byte profile (meta tensors: no device
              memory), a 1D call, a ``plan_2d=(2, 1)`` call (each layer of
              the period recomputed in a chunk of its own) and a
              ``step_memory_budget=`` call (the profile's
              ``sum(layer_bytes) + head_bytes - 1``), each under the same
              gates, the 2D ones' ``inner_*`` counters equal to the
              perfmodel's and ``flash_attention`` launched twice a step
              advanced plus once a layer recomputed; the device peak
              above what each call found allocated (logged before, in
              and after the reverse sweep), and the ``(2, 1)`` call's
              must be below the 1D call's.  And ``runner="fused"``
              (``decoder_fused``: the body's steps as PyTorch code, the
              ``entry_store`` and ``fold`` kernels around them) autotuned
              and at I=13, s=4 (``FUSED_PINNED``: forward chunks 4, 4, 5,
              reverse 4, 4, 4, 1), each under the same gates, with
              ``entry_store`` launched once a forward chunk (the probe's
              included), ``fold`` once a reverse chunk, the model kernel
              as the fused reverse runs the steps (phase A leaves out each
              segment's last chunk) and the reference's
              ``fused_segments``/``fused_boundary_copies``; beside a
              ``runner="compiled"`` gradient at I=13, s=4: the loss bit for
              bit, the same plan, the fused device peak at most two
              carries above the compiled one's.  The layer kernels
              (``layer_kernels``: the attention backward, rmsnorm, glu,
              rope and the projections, ``dense_fwd`` 4 a step an attention
              layer and 3 an MLP, ``dense_bwd`` once each in a step's vjp)
              launched as each call's plan implies: the forward
              kernels each time a chain step runs, the backward ones once a
              step's vjp, the final norm once each way.  The pinned fused
              gradient is also held against the same call through the
              plain versions (``_PlainVersions``), an fp32-compute call
              through the plain versions the referee, at phase
              ``families``' bf16 gate; walls and peaks of both logged.
              Then one fused advance of those 13 steps timed against the
              compiled advance.
10. ssm     — the same for ``mamba2-370m`` (48 layers, batch cut to 4)
              and ``ssd_scan``, with the fused gradients at I=14, s=4
              (segments 14, 14, 14, 6), the layer kernels of its body
              counted (``layer_kernels``, the projections 2 a layer) and
              the fused gradient held
              against the same call through the plain versions as in
              ``dense``.
11. moe     — the same for ``phi3.5-moe-42b`` at full width (d_model
              4096, 16 experts top-2 of d_ff 6400, capacity factor 1.25),
              batch cut to 2 and depth cut to ``MOE_LAYERS`` (4 chain steps
              of one ``attn_moe`` layer), ``flash_attention`` once a chain
              step and the body's layer kernels (``layer_kernels``: the
              MoE layer's routing, slots, dispatch, combine and experts'
              products, their backwards, and the attention's, norms' and
              projections') counted in every call; the reference's
              gradients wait in page-locked host
              memory while the offloaded calls run (in every decoder
              phase), and every top-2 routing choice of the offloaded call
              (forward sweep, probe, the reverse's recompute) must equal
              the reference forward's.  Then ``runner="fused"`` as in
              ``dense``, autotuned and at I=2, s=2 (``FUSED_PINNED``: two
              segments of one chunk), routing equal in every call, beside
              the compiled call at I=2, s=2 and against the plain
              versions' call (whose differing routing choices are
              logged).  Then one
              ``offload_params="moe_experts"`` call, the expert weights on
              the host, at the first call's schedule: bit for bit
              (``torch.equal``) another unstreamed call's loss and
              gradients, one parameter batch a segment and phase, each
              expert blob read once a phase.  Then the deepest phi3.5-moe
              the host RAM and the card allow (``moe_depth``; the host's
              MemAvailable is printed in phase ``device``): the unstreamed
              call must raise ``torch.cuda.OutOfMemoryError``, the streamed
              one must run, its loss within 1e-5 relative of a ``no_grad``
              forward that moves one layer's weights to the card at a
              time, every gradient finite.
12. families — the VLM and the encoder-decoder through ``train_loss`` and
              dense autograd at full width: ``internvl2-1b`` (24 layers,
              ``train_4k``: 1,024 patches and 3,072 text tokens, batch cut
              to ``FAMILY_BATCH``) with ``flash_attention`` (24 launches a
              forward) and the layer kernels held against the same call
              through the plain versions (``_PlainVersions``) at the bf16
              gate: the loss at 3e-2, and each leaf's scaled distance from
              an fp32-compute gradient (plain versions) at most 3e-2 above
              the plain bf16 gradient's (two bf16 gradients 24 layers
              deep differ by more than 3e-2 between themselves); and
              ``whisper-tiny`` (4 + 4 layers, 2,048 encoder frames, 448
              decoder tokens, the same batch), whose loss and gradients
              must be finite (its attention is 2,048 long at most: the
              dense path, no kernel).  Walls and device peaks logged.
13. timing  — each kernel, its plain version and the nearest library call
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
              phi3.5-moe's shape (there beside SDPA, the same function);
              ``entry_store`` at both decoders' carries beside its plain
              version and the copy engine (``copy_(non_blocking=True)``;
              its bound the bytes over PCIe 5.0 x16, 64 GB/s), ``fold`` at
              gemma2-2b's main-path chunk (the row) and at the synthetic
              add case beside its plain version and
              ``torch._foreach_add_`` + ``torch._foreach_copy_``;
              ``flash_attention_bwd`` at gemma2-2b's and phi3.5-moe's
              layers beside its plain version and SDPA's backward (its
              bound the five products of the backward at the bf16 peak),
              ``rmsnorm`` (beside ``F.rms_norm`` on ``1 + scale``, its
              backward beside that call's gradient through autograd),
              ``glu`` and ``rope``, forward and backward, at gemma2-2b's
              shapes (bound: bytes); mamba2-370m's ``ssd_scan_bwd`` (bound:
              its products at the bf16 peak), ``causal_conv`` (beside
              ``F.conv1d(groups=C)``, without the SiLU), ``dt_softplus``
              (beside ``F.softplus``) and ``gated_norm``, forward and
              backward, at its layer (bound: bytes); the projections' GEMM
              at each ``DENSE_CASES`` shape, forward, dx and dw, beside the
              plain version, cuBLAS with the bf16 weight made beforehand
              and the cast alone (bound: operations at the bf16 peak; the
              kernels line's rows at gemma2-2b's gate/up shape); the MoE
              layer's kernels at phi3.5-moe's (``_time_moe``: bound bytes,
              the gathers' kept rows only; the dispatch beside
              ``index_select``, its vjp beside ``index_add_``) and the
              experts' products at its gate/up and down shapes beside
              ``torch.bmm`` on bf16 weights plus the cast (bound:
              operations).
14. train   — three RMSProp steps through the offloaded LSTM gradient; the
              losses must fall.

``--phases ...,profile`` adds a ``torch.profiler`` pass over one warm
fused gradient of gemma2-2b (I=13, s=4), of mamba2-370m (I=14, s=4) and
of phi3.5-moe (4 layers, I=2, s=2) by kernel (``--profile-archs`` picks), split into the hand-written
kernels, the cuBLAS products and PyTorch's own, with their warm walls
autotuned and pinned (``tools/profile_fused.py``; with ``--parent DIR``
first for the checkout in ``DIR``, a ``git archive`` of another commit;
this tree's cuBLAS products must be the loss head's alone),
one main-path
call per LSTM schedule, captured and uncaptured, and one offloaded call in
each decoder phase (device kernel time by name and the device's busy share;
for the LSTM, the device time under each fused segment wrapper, kernel 1's
by caller), the host time of a warm LSTM call split by part, per segment
(``_HostSplit``: the wrappers, the runner, the executor, the Level-2
engine's calls and its threads), and one fused advance at the probe's shape
timed per call, captured and uncaptured.
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

PHASES = ("device", "build", "kernels", "main", "scan", "strategies",
          "level2", "resume", "dense", "ssm", "moe", "families", "timing",
          "train")
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

def host_meminfo() -> dict:
    """``/proc/meminfo`` in bytes, by field."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[name] = int(parts[0]) * (1024 if parts[1:] == ["kB"]
                                             else 1)
    return out


def vm_rss() -> int:
    """This process's resident set (``/proc/self/status``), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


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
    mem = host_meminfo()
    state["host_mem"] = {"avail": mem["MemAvailable"], "rss": vm_rss()}
    log(f"[device] host RAM: MemTotal {mem.get('MemTotal', -1):,} B, "
        f"MemAvailable {mem.get('MemAvailable', -1):,} B (/proc/meminfo); "
        f"this process {state['host_mem']['rss']:,} B resident")
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
    # registers and spills of the layer kernels (the attention backward's
    # accumulators are the ones that could spill)
    for lib in ("flash_attention_bwd", "rmsnorm", "glu", "rope", "dense",
                "moe"):
        for kern, regs, spill in ptxas_usage(build.BUILD_LOG.get(lib, "")):
            log(f"[build] {lib}: {kern}: {regs} registers, {spill}")
    # the bf16 kernels that must run on the tensor cores
    for lib, kernels in (("flash_attention", ("flash_fwd_bf16_kernel",)),
                         ("flash_attention_bwd", ("bwd_dq_bf16_kernel",
                                                  "bwd_dkdv_bf16_kernel")),
                         ("ssd_scan", ("ssd_state_bf16_kernel",
                                       "ssd_out_bf16_kernel")),
                         ("dense", ("dense_tc_kernel",))):
        counts = hmma_counts(build.library_path(lib))
        if counts is None:
            log(f"[build] {lib}: cuobjdump not found, HMMA not counted")
            continue
        for kern in kernels:
            n = sum(v for k, v in counts.items() if kern in k)
            require(n > 0, f"{lib}: {kern} issues no HMMA instruction")
            log(f"[build] {lib}: {kern} has {n} HMMA instructions "
                "(cuobjdump -sass)")


def ptxas_usage(text):
    """``(kernel, registers, spills)`` for each entry function in an
    ``nvcc -Xptxas -v`` report: the name as ``cu++filt`` demangles it (the
    mangled one without that tool), the registers used, and the spill
    stores and loads as ptxas prints them."""
    import re
    import shutil

    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill or "spills n/a"))
            name = None
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if out and os.path.exists(tool):
        names = subprocess.run([tool], input="\n".join(k for k, _, _ in out),
                               capture_output=True, text=True, timeout=60)
        if names.returncode == 0:
            out = [(d, r, sp) for d, (_, r, sp) in
                   zip(names.stdout.splitlines(), out)]
    return out


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


# the attention backward's cases: gemma2-2b's two layer kinds (attn_local,
# whose window of 4096 spans the sequence, and attn) and phi3.5-moe's layer
# at their phases' shapes, in bf16 and fp32, then FLASH_CASES' smaller
# cases with ragged edges, windows shorter than S, Sq < Sk, non-causal
FLASH_BWD_CASES = tuple(
    (f"{label}{' fp32' if dtype == 'float32' else ''}", dims, dtype, kw)
    for label, dims, kw in (
        ("gemma2-2b attn_local", (2, 4096, 4096, 8, 4, 256),
         {**GEMMA_KW, "window": 4096}),
        ("gemma2-2b attn", (2, 4096, 4096, 8, 4, 256), GEMMA_KW),
        ("phi3.5-moe layer", (2, 4096, 4096, 32, 8, 128), {}))
    for dtype in ("bfloat16", "float32")) + FLASH_CASES[3:]
# the scaled error (max |a - b| over max |b|) each kernel's outputs and
# cotangents may have against its plain version's: fp32 sums in another
# order; bf16 one rounding of each output (and, in the attention backward,
# of p and dS before their products, at other points than the plain version)
GRAD_TOL = {"flash_attention_bwd": {"float32": 2e-4, "bfloat16": 3e-2},
            "layers": {"float32": 1e-5, "bfloat16": 3e-2}}


def check_flash_bwd(torch, label, dims, dtype, kw, seed):
    """The attention backward kernel against its plain version
    (``attention._chunked_bwd``) on the flash forward kernel's ``out`` and
    ``lse``: dq, dk and dv each within ``GRAD_TOL`` of the plain version's
    max |value|; at the main path's layers two calls bit for bit.  Returns
    the max abs error."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import _chunked_bwd

    B, Sq, Sk, H, G, D = dims
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = _randn(torch, rng, (B, Sq, H, D), dt)
    k = _randn(torch, rng, (B, Sk, G, D), dt)
    v = _randn(torch, rng, (B, Sk, G, D), dt)
    dout = _randn(torch, rng, (B, Sq, H, D), dt)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    args = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
            1024, kw.get("scale"))
    want = _chunked_bwd(*args, (q, k, v, out, lse), dout)
    torch.cuda.synchronize()
    tol = GRAD_TOL["flash_attention_bwd"][dtype]
    errs = {n: scaled_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                                    want)}
    require(all(bool(torch.isfinite(a.float()).all()) for a in got)
            and max(errs.values()) <= tol,
            f"flash_attention_bwd {label}: scaled errors {errs} over {tol}")
    abs_err = max(max_err(a, b) for a, b in zip(got, want))
    line = (f"[kernels] flash_attention_bwd {label} {dims} {dtype}: scaled "
            "errors " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (gate {tol}), max abs err {abs_err:.3g}")
    if label.startswith("gemma2-2b") or label.startswith("phi3.5"):
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_attention_bwd {label}: two calls differ")
        line += "; two calls bit for bit"
    log(line)
    del got, want, out, lse
    torch.cuda.empty_cache()
    return abs_err


def check_flash_bwd_refused(torch):
    """A bf16 head dim outside {16, 32, 64, 128, 256} is refused."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(12)
    q = _randn(torch, rng, (1, 64, 2, 96), torch.bfloat16)
    lse = torch.zeros((1, 2, 1, 64), device="cuda")
    try:
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    except ValueError:
        log("[kernels] flash_attention_bwd bf16 D=96: refused (ValueError)")
    else:
        raise SmokeFailure("flash_attention_bwd bf16 D=96 was not refused")


# gemma2-2b's layer shapes on the dense phase's path (B=2, S=4096)
GEMMA_ROWS, GEMMA_D, GEMMA_FF = 2 * 4096, 2304, 9216
GEMMA_QK = ((2, 4096, 8, 256), (2, 4096, 4, 256))


def _twice_equal(torch, fn):
    """``fn()`` twice: the outputs (a tuple) bit for bit."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return a, all(_bits_equal(torch, x, y) for x, y in zip(a, b))


def check_layer_kernels(torch) -> dict:
    """rmsnorm (with and without the fused residual add), glu (GeGLU,
    gemma2-2b's, and SwiGLU, phi3.5-moe's) and rope (q and k in one
    launch), forward and backward, against their plain versions at
    gemma2-2b's shapes, bf16 and fp32 (``GRAD_TOL["layers"]``), each two
    calls bit for bit.  Returns the max abs error of each kernel (bf16, the
    main path's dtype)."""
    import numpy as np

    from repro_torch.kernels import glu as glu_mod
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.models.layers import rope_table

    rng = np.random.default_rng(70)
    errs = {}

    def gate(name, dtype, label, pairs, same):
        tol = GRAD_TOL["layers"][dtype]
        e = max(scaled_err(a, b) for a, b in pairs)
        require(same and e <= tol and all(
            bool(torch.isfinite(a.float()).all()) for a, _ in pairs),
            f"{name} {label} {dtype}: scaled error {e} over {tol}, or two "
            f"calls differ ({not same})")
        ab = max(max_err(a, b) for a, b in pairs)
        log(f"[kernels] {name} {label} {dtype}: scaled error {e:.3g} (gate "
            f"{tol}), max abs err {ab:.3g}; two calls bit for bit")
        if dtype == "bfloat16":
            errs[name] = max(errs.get(name, 0.0), ab)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = _randn(torch, rng, (2, 4096, GEMMA_D), dt)
        res = _randn(torch, rng, (2, 4096, GEMMA_D), dt)
        g = _randn(torch, rng, (2, 4096, GEMMA_D), dt)
        scale = _randn(torch, rng, (GEMMA_D,), torch.float32, 0.3)
        for label, r in (("plain form", None), ("with the residual", res)):
            (out, rstd), same = _twice_equal(
                torch, lambda: rn.rmsnorm(x, scale, r, out_dtype=dt))
            want, _ = rn.rmsnorm_fwd_plain(x, scale, r, 1e-6, dt)
            gate("rmsnorm", dtype, label, [(out, want)], same)
        (dx, ds), same = _twice_equal(
            torch, lambda: rn.rmsnorm_bwd(g, x, scale, rstd))
        want = rn.rmsnorm_bwd_plain(g, x, scale, 1e-6, dt)
        gate("rmsnorm_bwd", dtype, "dx, dscale", list(zip((dx, ds), want)),
             same)
        del x, res, g, out, rstd, dx, ds, want
        gu = [_randn(torch, rng, (2, 4096, GEMMA_FF), dt) for _ in range(3)]
        for act in ("gelu", "silu"):
            (h,), same = _twice_equal(
                torch, lambda: (glu_mod.glu(gu[0], gu[1], act),))
            gate("glu", dtype, act, [(h, glu_mod.glu_plain(gu[0], gu[1],
                                                           act))], same)
            got, same = _twice_equal(
                torch, lambda: glu_mod.glu_bwd(gu[2], gu[0], gu[1], act))
            gate("glu_bwd", dtype, act, list(zip(
                got, glu_mod.glu_bwd_plain(gu[2], gu[0], gu[1], act))),
                same)
        del gu, h, got
        cos, sin = rope_table(4096, 256, device="cuda")
        qk = [_randn(torch, rng, s, dt) for s in GEMMA_QK]
        gs = [_randn(torch, rng, s, dt) for s in GEMMA_QK]
        got, same = _twice_equal(torch, lambda: rope_mod.rope(qk, cos, sin))
        gate("rope", dtype, "q and k", [
            (y, rope_mod.rope_plain(x, cos, sin)) for x, y in zip(qk, got)],
            same)
        got, same = _twice_equal(torch,
                                 lambda: rope_mod.rope_bwd(gs, cos, sin))
        gate("rope_bwd", dtype, "q and k", [
            (y, rope_mod.rope_bwd_plain(g, x, cos, sin))
            for x, g, y in zip(qk, gs, got)], same)
        del qk, gs, got
        torch.cuda.empty_cache()
    return errs


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


# mamba2-370m's layer at the ssm phase's shape: the SSD's (B, T, H, G, P, N,
# chunk), the conv's channels (x, B, C) and width
MAMBA_SSD = (4, 4096, 32, 1, 64, 128, 128)
MAMBA_CONV = (2304, 4)
# label, SSD dims, dtype name, with an entry state: the first is every
# mamba2-370m layer's backward at the ssm phase's shape (no entry state)
SSD_BWD_CASES = (
    ("mamba2-370m layer", MAMBA_SSD, "bfloat16", False),
    ("small, fp32, groups and h0", (2, 520, 8, 2, 32, 64, 64), "float32",
     True),
)
# each leaf of the SSD backward: the axes of the RMS its excess is over
# (dx, db, dc per head or group over the sequence, ddt per head, dA over
# the heads, dh0 per head over its state)
SSD_BWD_DIMS = (("dx", (1, 3)), ("ddt", (1,)), ("dA", (0,)), ("db", (1, 3)),
                ("dc", (1, 3)), ("dh0", (2, 3)))


def _ssd_bwd_args(torch, rng, dims, dtype, with_h0):
    B, T, H, G, P, N, _ = dims
    dt_, f32 = getattr(torch, dtype), torch.float32
    x = _randn(torch, rng, (B, T, H, P), dt_, 0.5)
    dt = torch.nn.functional.softplus(_randn(torch, rng, (B, T, H), f32))
    A = -torch.exp(_randn(torch, rng, (H,), f32, 0.3))
    b = _randn(torch, rng, (B, T, G, N), dt_, 0.5)
    c = _randn(torch, rng, (B, T, G, N), dt_, 0.5)
    h0 = _randn(torch, rng, (B, H, P, N), f32, 0.5) if with_h0 else None
    dy = _randn(torch, rng, (B, T, H, P), dt_)
    dhf = _randn(torch, rng, (B, H, P, N), f32)
    return x, dt, A, b, c, h0, dy, dhf


def _ssd_bwd_dropped(torch, args, chunk):
    """The plain backward with the cotangent carried from chunk 1 into
    chunk 0 dropped: chunk 0 differentiated on its own (a zero final-state
    cotangent), the rest from the state entering chunk 1; (dx, ddt, db,
    dc)."""
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, A, b, c, h0, dy, dhf = args
    head = [t[:, :chunk].contiguous() for t in (x, dt, b, c, dy)]
    tail = [t[:, chunk:].contiguous() for t in (x, dt, b, c, dy)]
    _, h1 = ssd.ssd_scan_plain(head[0], head[1], A, head[2], head[3], h0)
    g0 = ssd.ssd_scan_bwd_plain(head[0], head[1], A, head[2], head[3], h0,
                                head[4], None, chunk=chunk)
    g1 = ssd.ssd_scan_bwd_plain(tail[0], tail[1], A, tail[2], tail[3],
                                h1.contiguous(), tail[4], dhf, chunk=chunk)
    return [torch.cat([g0[i], g1[i]], dim=1) for i in (0, 1, 3, 4)]


def check_ssd_bwd(torch, label, dims, dtype, with_h0, seed):
    """The SSD-scan backward kernel against its plain version (autograd
    over ``ssd_chunked_plain``), per element (``TOL["ssd_scan"]``, the RMS
    over ``SSD_BWD_DIMS``), two calls bit for bit; at the main path's shape
    a backward that drops one chunk's carried cotangent must fail the same
    gate.  Returns the max abs error over the leaves."""
    import numpy as np

    from repro_torch.kernels import ssd_scan as ssd

    chunk = dims[-1]
    args = _ssd_bwd_args(torch, np.random.default_rng(seed), dims, dtype,
                         with_h0)
    got, same = _twice_equal(torch, lambda: tuple(
        t for t in ssd.ssd_scan_bwd(*args, chunk=chunk) if t is not None))
    want = [t for t in ssd.ssd_scan_bwd_plain(*args, chunk=chunk)
            if t is not None]
    torch.cuda.synchronize()
    rtol, atol = TOL["ssd_scan"][dtype]
    ex = {name: excess(a, b, rtol, d)
          for (name, d), a, b in zip(SSD_BWD_DIMS, got, want)}
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(same and max(ex.values()) <= atol and all(
        bool(torch.isfinite(a.float()).all()) for a in got),
        f"ssd_scan_bwd {label}: scaled excess {ex} (rtol {rtol}, atol "
        f"{atol}), or two calls differ ({not same})")
    log(f"[kernels] ssd_scan_bwd {label} {dims} {dtype}: max abs err "
        f"{err:.3g}, scaled excess " + ", ".join(
            f"{k} {v:.3g}" for k, v in ex.items())
        + f" (rtol {rtol}, atol {atol}); two calls bit for bit")
    if label == "mamba2-370m layer":
        bad = _ssd_bwd_dropped(torch, args, chunk)
        ex_bad = max(excess(a, want[i], rtol, SSD_BWD_DIMS[i][1])
                     for i, a in zip((0, 1, 3, 4), bad))
        require(ex_bad > atol, f"ssd_scan_bwd {label}: a backward that "
                f"drops the cotangent carried from chunk 1 into chunk 0 "
                f"passes the check ({ex_bad})")
        log(f"[kernels] ssd_scan_bwd {label}: the cotangent carried into "
            f"chunk 0 dropped would give a scaled excess of {ex_bad:.3g}")
        del bad
    del got, want, args
    torch.cuda.empty_cache()
    return err


# (rtol, atol) of the elementwise outputs of mamba2's layer kernels against
# their plain versions, atol in units of the row's RMS (fp32: sums in other
# orders; bf16: one rounding against the plain version's; the conv is held
# against its plain version in fp32 on the same values, since in bf16 that
# rounds every product and partial sum); and the scaled error of their
# sums over rows (dD, dscale, the conv's weight and bias, dt_bias)
MAMBA_TOL = {"float32": ((1e-5, 1e-5), 1e-4),
             "bfloat16": ((1e-2, 3e-2), 3e-2)}


def check_mamba_layer_kernels(torch) -> dict:
    """gated_norm, causal_conv and dt_softplus, forward and backward,
    against their plain versions at mamba2-370m's layer (the inputs laid
    out as the model's: z, xBC and dt_raw column slices of one projection
    row, x the conv output's first columns) in bf16 and at a small fp32
    shape, per element (``MAMBA_TOL``), each two calls bit for bit.
    Returns the max abs error of each kernel (bf16, the main path's)."""
    import numpy as np

    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import gated_norm as gn

    rng = np.random.default_rng(72)
    errs = {}
    f32 = torch.float32

    def gate(name, dtype, label, elem, sums, same, plain=None):
        """``plain``: the plain version's outputs, where ``elem`` and
        ``sums`` hold the kernel against the plain version in fp32 on the
        same values (the conv's: its plain version rounds every product and
        partial sum to bf16, the kernel once); the max abs error is the
        kernel's from ``plain`` then."""
        (rtol, atol), stol = MAMBA_TOL[dtype]
        e = max([excess(a, b, rtol) for a, b in elem] or [0.0])
        es = max([scaled_err(a, b) for a, b in sums] or [0.0])
        pairs = elem + sums
        require(same and e <= atol and es <= stol and all(
            bool(torch.isfinite(a.float()).all()) for a, _ in pairs),
            f"{name} {label} {dtype}: scaled excess {e} (atol {atol}), sums' "
            f"scaled error {es} (over {stol}), or two calls differ "
            f"({not same})")
        against = pairs if plain is None else list(zip(
            [a for a, _ in pairs], plain))
        ab = max(max_err(a, b) for a, b in against)
        if plain is not None:
            ep = max(excess(b, r, rtol) for (_, r), b in zip(elem, plain))
            log(f"[kernels] {name} {label} {dtype}: held against the plain "
                f"version in fp32 on the same values; the bf16 plain "
                f"version's own scaled excess from it {ep:.3g}")
        log(f"[kernels] {name} {label} {dtype}: scaled excess {e:.3g} "
            f"(rtol {rtol}, atol {atol}), sums' scaled error {es:.3g} (gate "
            f"{stol}), max abs err {ab:.3g}; two calls bit for bit")
        if dtype == "bfloat16":
            errs[name] = max(errs.get(name, 0.0), ab)

    B, T, H, _, P, N, _ = MAMBA_SSD
    for dtype, (B, T, H, P, N) in (("bfloat16", (B, T, H, P, N)),
                                   ("float32", (2, 300, 4, 16, 16))):
        dt_ = getattr(torch, dtype)
        d, K = H * P, MAMBA_CONV[1]
        C = d + 2 * N
        proj = _randn(torch, rng, (B, T, 2 * d + 2 * N + H), dt_)
        z, xbc, raw = proj[..., :d], proj[..., d:d + C], proj[..., d + C:]
        label = f"({B}, {T}, {C} channels, {H} heads)"
        # the conv, with the width and weight scale of init_mamba2
        w = _randn(torch, rng, (K, C), dt_, 0.2)
        bias = _randn(torch, rng, (C,), dt_, 0.1)
        (out,), same = _twice_equal(
            torch, lambda: (cc.causal_conv(xbc, w, bias),))
        f32s = [t.float() for t in (xbc, w, bias)]
        gate("causal_conv", dtype, label,
             [(out, cc.causal_conv_plain(*f32s, None)[0])], [], same,
             [cc.causal_conv_plain(xbc, w, bias, None)[0]])
        g = _randn(torch, rng, (B, T, C), dt_)
        got, same = _twice_equal(torch, lambda: cc.causal_conv_bwd(
            g, xbc, w, bias)[:3])
        want = cc.causal_conv_bwd_plain(g.float(), *f32s, None)
        gate("causal_conv_bwd", dtype, label, [(got[0], want[0])],
             list(zip(got[1:], want[1:3])), same,
             cc.causal_conv_bwd_plain(g, xbc, w, bias, None)[:3])
        del got, want, g, f32s
        # the step sizes
        dtb = _randn(torch, rng, (H,), f32)
        (dts,), same = _twice_equal(torch, lambda: (ds.dt_softplus(raw, dtb),))
        gate("dt_softplus", dtype, label,
             [(dts, ds.dt_softplus_plain(raw, dtb))], [], same)
        g = _randn(torch, rng, (B, T, H), f32)
        got, same = _twice_equal(torch, lambda: ds.dt_softplus_bwd(g, raw,
                                                                    dtb))
        want = ds.dt_softplus_bwd_plain(g, raw, dtb)
        gate("dt_softplus_bwd", dtype, label, [(got[0], want[0])],
             [(got[1], want[1])], same)
        del got, want, g
        # the gated norm on the SSD's y and the conv output's x
        y = _randn(torch, rng, (B, T, H, P), dt_)
        x = out[..., :d].reshape(B, T, H, P)
        D = _randn(torch, rng, (H,), f32)
        scale = _randn(torch, rng, (d,), f32, 0.3)
        (o, rstd), same = _twice_equal(torch, lambda: gn.gated_norm(
            y, x, D, z, scale, out_dtype=dt_))
        gate("gated_norm", dtype, label,
             [(o, gn.gated_norm_plain(y, x, D, z, scale, 1e-6, dt_))], [],
             same)
        g = _randn(torch, rng, (B, T, d), dt_)
        got, same = _twice_equal(torch, lambda: gn.gated_norm_bwd(
            g, y, x, D, z, scale, rstd))
        want = gn.gated_norm_bwd_plain(g, y, x, D, z, scale, 1e-6, dt_)
        gate("gated_norm_bwd", dtype, label,
             [(got[i], want[i]) for i in (0, 1, 3)],
             [(got[i], want[i]) for i in (2, 4)], same)
        del got, want, g, y, x, o, rstd, out, proj
        torch.cuda.empty_cache()
    return errs


# label, (M, K, N): the projections of gemma2-2b's layer at the dense
# phase's shape (B=2, S=4096) and of mamba2-370m's at the ssm phase's (B=4)
DENSE_CASES = (("gemma2-2b wq", (8192, 2304, 2048)),
               ("gemma2-2b wk, wv", (8192, 2304, 1024)),
               ("gemma2-2b wo", (8192, 2048, 2304)),
               ("gemma2-2b gate, up", (8192, 2304, 9216)),
               ("gemma2-2b down", (8192, 9216, 2304)),
               ("mamba2-370m in_proj", (16384, 1024, 4384)),
               ("mamba2-370m out_proj", (16384, 2048, 1024)))
# (rtol, atol) per element, atol in units of the output row's RMS: bf16, the
# kernel's and cuBLAS's fp32 sums (in other orders) each rounded once to
# bf16 (1 ulp is at most 2^-7 of |ref|); fp32, sums in other orders
DENSE_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}


@contextlib.contextmanager
def _full_precision_reductions(torch):
    """cuBLAS's bf16 products with fp32 reductions throughout (no split-K
    partial sums rounded to bf16), for a plain reference."""
    m = torch.backends.cuda.matmul
    was = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = was


def check_dense(torch) -> dict:
    """The projection GEMM (``dense_fwd``, and ``dense_bwd``'s dx and dw)
    against its plain version at every projection of gemma2-2b's and
    mamba2-370m's layers (``DENSE_CASES``; x and dy bf16, w the fp32
    parameter, cast in the kernel's load) and at a small ragged fp32 shape
    with w in fp32 and in bf16, per element at ``DENSE_TOL`` (bf16's where
    x or the output is bf16), each two calls bit for bit; a dw whose sum
    drops the last 32 rows (one stage of its walk over M) must fail the
    gate.  Returns the max abs error of each (bf16, the main path's)."""
    import numpy as np

    from repro_torch.kernels import dense as dn

    rng = np.random.default_rng(73)
    errs = {"dense_fwd": 0.0, "dense_bwd": 0.0}

    def gate(name, label, x_dt, pairs, same):
        worst = 0.0
        for a, b in pairs:
            dt = "bfloat16" if torch.bfloat16 in (x_dt, a.dtype) \
                else "float32"
            rtol, atol = DENSE_TOL[dt]
            worst = max(worst, excess(a, b, rtol) / atol)
        ab = max(max_err(a, b) for a, b in pairs)
        require(same and worst <= 1.0 and all(
            bool(torch.isfinite(a.float()).all()) for a, _ in pairs),
            f"{name} {label}: {worst:.3g} of the gate {DENSE_TOL}, or two "
            f"calls differ ({not same})")
        log(f"[kernels] {name} {label}: per-element excess {worst:.3g} of "
            f"the gate, max abs err {ab:.3g}; two calls bit for bit")
        if x_dt == torch.bfloat16:
            errs[name] = max(errs[name], ab)

    cases = [(lbl, dims, torch.bfloat16, torch.float32)
             for lbl, dims in DENSE_CASES]
    cases += [("ragged fp32, w fp32", (77, 72, 37), torch.float32,
               torch.float32),
              ("ragged fp32, w bf16", (77, 72, 37), torch.float32,
               torch.bfloat16)]
    for i, (label, (M, K, N), x_dt, w_dt) in enumerate(cases):
        label = f"{label} (M={M}, K={K}, N={N}, x {str(x_dt)[6:]}, w " \
            f"{str(w_dt)[6:]})"
        x = _randn(torch, rng, (M, K), x_dt)
        w = _randn(torch, rng, (K, N), torch.float32, K ** -0.5).to(w_dt)
        dy = _randn(torch, rng, (M, N), x_dt)
        (y,), same = _twice_equal(torch, lambda: (dn.dense_fwd(x, w),))
        with _full_precision_reductions(torch):
            want = dn.dense_fwd_plain(x, w)
        gate("dense_fwd", label, x_dt, [(y, want)], same)
        del y, want
        got, same = _twice_equal(torch, lambda: dn.dense_bwd(dy, x, w))
        with _full_precision_reductions(torch):
            want = dn.dense_bwd_plain(dy, x, w)
        require(got[1].dtype == w_dt, f"dense_bwd {label}: dw is "
                f"{got[1].dtype}, w {w_dt}")
        gate("dense_bwd", label, x_dt, list(zip(got, want)), same)
        if i == 0:
            # the negative check: the last stage of dw's walk over M left out
            _, short = dn.dense_bwd(dy[:-32], x[:-32], w, need_dx=False)
            torch.cuda.synchronize()
            rtol, atol = DENSE_TOL["bfloat16"]
            e = excess(short, want[1], rtol) / atol
            require(e > 1.0, f"dense_bwd {label}: a dw without the last 32 "
                    f"rows passes the gate ({e:.3g} of it)")
            log(f"[kernels] dense_bwd {label}: a dw without the last 32 rows"
                f" is {e:.3g} of the gate: rejected")
            del short
        del got, want, x, w, dy
        torch.cuda.empty_cache()
    return errs


# phi3.5-moe's MoE layer at the moe phase's shape: G groups (the batch) of S
# tokens of width d, E experts top-k of width f; capacity factors: the
# config's, and one under which experts overflow
MOE_LAYER = (2, 4096, 4096, 16, 2, 6400)
MOE_CFS = (1.25, 0.25)
# the routing kernel against its plain version: probs and weights (fp32,
# the logits summed in another order) absolute; dx (bf16: one rounding
# apart) and dW_r (fp32 sums over 8192 tokens in another order) scaled by
# the plain version's max |value|; a choice may differ only where the plain
# probs of the two choices are within ROUTE_TIE
MOE_TOL = {"probs": 1e-5, "dx": 1e-2, "dw": 1e-4, "combine": 1e-2,
           "dweights": 1e-4}
ROUTE_TIE = 1e-5


def _moe_inputs(torch, rng):
    """x, the router weight and the routing kernel's choices at
    ``MOE_LAYER``."""
    from repro_torch.kernels import moe as mk

    G, S, d, E, k, f = MOE_LAYER
    x = _randn(torch, rng, (G, S, d), torch.bfloat16)
    w = _randn(torch, rng, (d, E), torch.float32, d ** -0.5)
    return x, w, mk.moe_route(x, w, k)


def check_moe(torch) -> dict:
    """The MoE layer's kernels against their plain versions at
    phi3.5-moe's layer (``MOE_LAYER``, bf16 x, fp32 router): the routing
    (``MOE_TOL``; a choice that differs must be a near-tie of the plain
    probs, ``ROUTE_TIE``, and its token's cotangents are zeroed for the
    backward's comparison), and at each capacity factor of ``MOE_CFS``
    (0.25: experts overflow) the slots (equal), the dispatch and its vjp
    (bit for bit), the combine and its vjp (``MOE_TOL``); the experts'
    products (gate/up and down) per element at ``DENSE_TOL`` against the
    plain version on cuBLAS with fp32 reductions.  Every kernel twice, bit
    for bit.  Returns each kernel's max abs error."""
    import numpy as np

    from repro_torch.kernels import dense as dn
    from repro_torch.kernels import moe as mk
    from repro_torch.models.moe import _capacity

    G, S, d, E, k, f = MOE_LAYER
    rng = np.random.default_rng(75)
    bf16 = torch.bfloat16
    x, w, _ = _moe_inputs(torch, rng)
    (weights, idx, probs, _, ce), same = _twice_equal(
        torch, lambda: mk.moe_route(x, w, k))
    want_w, want_idx, want_p = mk.route_plain(x, w, k)
    flipped = (idx != want_idx).any(-1)
    gap = (want_p.gather(-1, idx) - want_p.gather(-1, want_idx)).abs()
    ties = bool((gap.amax(-1)[flipped] <= ROUTE_TIE).all())
    agree = ~flipped
    e_p = max_err(probs, want_p)
    e_w = max_err(weights[agree], want_w[agree])
    require(same and ties and e_p <= MOE_TOL["probs"]
            and e_w <= MOE_TOL["probs"],
            f"moe_route: probs err {e_p:.3g}, weights err {e_w:.3g} (tol "
            f"{MOE_TOL['probs']}); {int(flipped.sum())} tokens routed "
            f"otherwise, all near-ties: {ties}; two calls equal: {same}")
    log(f"[kernels] moe_route (G={G}, S={S}, d={d}, E={E}, top-{k}): probs "
        f"max abs err {e_p:.3g}, weights {e_w:.3g}; {int(flipped.sum())} of "
        f"{G * S} tokens routed otherwise than the plain version (near-ties "
        f"within {ROUTE_TIE}); two calls bit for bit")
    errs = {"moe_route": max(e_p, e_w)}
    keep = agree[..., None].float()
    dweights = _randn(torch, rng, (G, S, k), torch.float32) * keep
    # the aux loss's cotangent (its dprobs spread over every token; a
    # flipped choice moves 1 / (G S) of a count between experts, far
    # below the gate)
    daux = torch.tensor(0.7, device="cuda")
    (dx, dw), same = _twice_equal(torch, lambda: mk.moe_route_bwd(
        dweights, daux, x, w, probs, idx, ce))
    want_dx, want_dw = mk.route_bwd_plain(dweights, daux, x, w, k)
    e_dx, e_dw = scaled_err(dx, want_dx), scaled_err(dw, want_dw)
    require(same and e_dx <= MOE_TOL["dx"] and e_dw <= MOE_TOL["dw"],
            f"moe_route_bwd: dx {e_dx:.3g} (tol {MOE_TOL['dx']}), dW_r "
            f"{e_dw:.3g} (tol {MOE_TOL['dw']}) of the plain max; two calls "
            f"equal: {same}")
    log(f"[kernels] moe_route_bwd: dx scaled err {e_dx:.3g}, dW_r "
        f"{e_dw:.3g}; two calls bit for bit")
    errs["moe_route_bwd"] = max(max_err(dx, want_dx), max_err(dw, want_dw))
    del dx, dw, want_dx, want_dw
    errs.update({n: 0.0 for n in ("moe_slots", "moe_dispatch",
                                  "moe_dispatch_bwd")})
    errs["moe_combine"] = errs["moe_combine_bwd"] = 0.0
    for cf in MOE_CFS:
        C = _capacity(S, E, k, cf)
        got, same = _twice_equal(torch, lambda: mk.moe_slots(idx, E, C))
        want = mk.slots_plain(idx, E, C)
        choice_slot, slot_src, routed = got
        dropped = int((choice_slot < 0).sum())
        require(same and all(torch.equal(a, b) for a, b in zip(got, want))
                and (dropped > 0 or cf >= 1.0),
                f"moe_slots C={C}: differ from the plain version, or two "
                f"calls differ, or no choice dropped at capacity factor "
                f"{cf}")
        (buckets,), same = _twice_equal(
            torch, lambda: (mk.moe_dispatch(x, slot_src, k),))
        require(same and _bits_equal(torch, buckets,
                                     mk.dispatch_plain(x, slot_src, k)),
                f"moe_dispatch C={C}: not bit for bit the plain version's")
        dexp = _randn(torch, rng, tuple(buckets.shape), bf16)
        (dxd,), same = _twice_equal(
            torch, lambda: (mk.moe_dispatch_bwd(dexp, choice_slot),))
        require(same and _bits_equal(
            torch, dxd, mk.dispatch_bwd_plain(dexp, choice_slot)),
            f"moe_dispatch_bwd C={C}: not bit for bit the plain version's")
        del buckets, dxd
        rows = dexp
        (y,), same = _twice_equal(
            torch, lambda: (mk.moe_combine(rows, weights, choice_slot,
                                           bf16),))
        want_y = mk.combine_plain(rows, weights, choice_slot, bf16)
        e_y = scaled_err(y, want_y)
        bits = _bits_equal(torch, y, want_y)
        require(same and e_y <= MOE_TOL["combine"],
                f"moe_combine C={C}: scaled err {e_y:.3g} (tol "
                f"{MOE_TOL['combine']}); two calls equal: {same}")
        dy = _randn(torch, rng, (G, S, d), bf16)
        got, same = _twice_equal(torch, lambda: mk.moe_combine_bwd(
            dy, rows, weights, choice_slot, slot_src))
        want = mk.combine_bwd_plain(dy, rows, weights, choice_slot,
                                    slot_src)
        e_r, e_dw = scaled_err(got[0], want[0]), scaled_err(got[1], want[1])
        require(same and e_r <= MOE_TOL["combine"]
                and e_dw <= MOE_TOL["dweights"],
                f"moe_combine_bwd C={C}: rows {e_r:.3g}, weights {e_dw:.3g}"
                f" (tol {MOE_TOL}); two calls equal: {same}")
        kept = int((slot_src >= 0).sum())
        log(f"[kernels] MoE slots at capacity factor {cf} (C={C}): equal to "
            f"the plain version's, {kept} of {G * S * k} choices kept, "
            f"{dropped} dropped; dispatch and its vjp bit for bit; combine "
            f"scaled err {e_y:.3g} (bit for bit: {bits}), its vjp rows "
            f"{e_r:.3g}, weights {e_dw:.3g}; every kernel two calls bit for "
            "bit")
        if cf == MOE_CFS[0]:
            errs["moe_combine"] = max_err(y, want_y)
            errs["moe_combine_bwd"] = max(max_err(got[0], want[0]),
                                          max_err(got[1], want[1]))
        del rows, dexp, y, want_y, dy, got, want
        torch.cuda.empty_cache()
    # the experts' products, at the config's capacity: E x (G C) rows
    M = G * _capacity(S, E, k, MOE_CFS[0])
    errs["expert_fwd"] = errs["expert_bwd"] = 0.0
    for label, K, N in (("gate/up", d, f), ("down", f, d)):
        xe = _randn(torch, rng, (E, M, K), bf16)
        we = _randn(torch, rng, (E, K, N), torch.float32, K ** -0.5)
        dy = _randn(torch, rng, (E, M, N), bf16)
        (y,), same = _twice_equal(torch, lambda: (dn.expert_fwd(xe, we),))
        with _full_precision_reductions(torch):
            want = dn.expert_fwd_plain(xe, we)
        rtol, atol = DENSE_TOL["bfloat16"]
        e_y = excess(y, want, rtol) / atol
        require(same and e_y <= 1.0, f"expert_fwd {label}: {e_y:.3g} of "
                f"the gate {DENSE_TOL['bfloat16']}; two calls equal: {same}")
        errs["expert_fwd"] = max(errs["expert_fwd"], max_err(y, want))
        del y, want
        got, same = _twice_equal(torch, lambda: dn.expert_bwd(dy, xe, we))
        with _full_precision_reductions(torch):
            want = dn.expert_bwd_plain(dy, xe, we)
        e_b = max(excess(a, b, rtol) / atol for a, b in zip(got, want))
        require(same and e_b <= 1.0 and got[1].dtype == torch.float32,
                f"expert_bwd {label}: {e_b:.3g} of the gate; two calls "
                f"equal: {same}")
        errs["expert_bwd"] = max(errs["expert_bwd"],
                                 *(max_err(a, b) for a, b in zip(got, want)))
        log(f"[kernels] experts {label} (E={E}, M={M}, K={K}, N={N}, x bf16,"
            f" w fp32): forward {e_y:.3g}, dx and dw {e_b:.3g} of the gate "
            f"{DENSE_TOL['bfloat16']}; two calls bit for bit")
        del xe, we, dy, got, want
        torch.cuda.empty_cache()
    return errs


# the carries the generic fused segments store at each chunk entry: the
# hidden state (bf16) and the aux accumulator (0-d fp32) of gemma2-2b at
# the dense phase's shape and of mamba2-370m at the ssm phase's
CARRIES = {"gemma2-2b": (2, 4096, 2304), "mamba2-370m": (4, 4096, 1024)}
PCIE_BYTES_PER_S = 64e9   # PCIe 5.0 x16, each way (the host link)


def _gen(torch, seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def generic_carry(torch, arch, seed):
    g = _gen(torch, seed)
    return [torch.randn(CARRIES[arch], generator=g, device="cuda").to(
        torch.bfloat16), torch.randn((), generator=g, device="cuda")]


def _bits_equal(torch, a, b) -> bool:
    def bits(t):
        t = t.contiguous()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a).cpu(), bits(b).cpu())


def check_entry_store(torch) -> None:
    """``entry_store`` bit for bit (``torch.equal`` of the bits) against its
    plain version (``dst.copy_(src)``) at both decoders' carries, a 0-d
    fp32 leaf, a bf16 leaf of odd length and a leaf 4 bytes into its
    buffer (the byte path), each into page-locked slots from the pools the
    runner takes them from."""
    from repro_torch.core.offload import _slot
    from repro_torch.kernels import segment_generic as sg

    g = _gen(torch, 50)
    buf = torch.randn((1 << 20) + 3, generator=g, device="cuda")
    cases = {arch: generic_carry(torch, arch, 51 + i)
             for i, arch in enumerate(CARRIES)}
    cases["0-d fp32"] = [torch.randn((), generator=g, device="cuda")]
    cases["odd bf16"] = [torch.randn((1001,), generator=g,
                                     device="cuda").to(torch.bfloat16)]
    cases["misaligned fp32"] = [buf[1:]]
    for label, leaves in cases.items():
        dsts = [_slot(t, pin=True) for t in leaves]
        plain = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in leaves]
        sg.entry_store_plain(leaves, plain)
        sg.entry_store(leaves, dsts).synchronize()
        require(all(_bits_equal(torch, a, b) for a, b in zip(dsts, plain)),
                f"entry_store {label}: not bit for bit its plain version")
        log(f"[kernels] entry_store {label} "
            f"{[tuple(t.shape) for t in leaves]}: bit for bit its plain "
            "version")


def _gemma_period(torch, seed):
    """``(layer leaves, other leaves)`` of gemma2-2b's parameters at two
    layers (one chain step), random from ``seed``."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models.model_factory import get_model

    cfg = get_config("gemma2-2b").replace(n_layers=2)
    params = get_model(cfg).init(_gen(torch, seed), device="cuda")
    period = pytree.tree_leaves(params.pop("layers"))
    others = [tuple(t.shape) for t in pytree.tree_leaves(params)]
    del params
    return period, others


FOLD_STEPS = 4   # the pinned gemma2-2b schedule's reverse chunk (I=13, s=4)


def generic_fold_chunk(torch, seed=62):
    """One reverse chunk's fold as gemma2-2b's main path makes it at the
    pinned schedule: each of the 22 weight cotangents of each of the
    chunk's 4 chain steps (8 layers) copied into its row of the full-chain
    buffer (the rows past the first, as a later chunk's are); the
    parameters outside the chain's ``xs`` (the embedding, the final norm)
    are not read by the steps, so their cotangents are broadcast zeros,
    skipped, and the fold adds nothing.  Returns ``(gacc, dps, full, rows,
    src_rows)``: ``rows(full)`` the destination views, in the order
    :func:`segment_generic.reverse` passes them."""
    period, others = _gemma_period(torch, seed)
    g = _gen(torch, seed + 1)
    full = [torch.zeros((FOLD_STEPS + 1, *t.shape[1:]), device="cuda")
            for t in period]
    src_rows = [torch.randn(t.shape[1:], generator=g, device="cuda")
                for t in period for _ in range(FOLD_STEPS)]
    zero = torch.zeros((), device="cuda")
    gacc = {f"o{i}": zero.expand(sh) for i, sh in enumerate(others)}
    dp = {f"o{i}": zero.expand(sh) for i, sh in enumerate(others)}
    del period
    return gacc, [dp], full, lambda fs: [
        f[k] for f in fs for k in range(1, FOLD_STEPS + 1)], src_rows


def generic_fold_case(torch, seed=60):
    """A synthetic fold that takes every branch of the kernel, at a
    gemma2-2b chunk's width (the decoders' own folds only copy, as
    :func:`generic_fold_chunk` does): each weight cotangent into its rows
    of a full-chain buffer, plus accumulator adds of one period's weights
    in fp32 and a few bf16, mixed, fresh and unread leaves.  Returns
    ``(gacc, dps, full, rows, src_rows)`` as :func:`generic_fold_chunk`
    does."""
    period, _ = _gemma_period(torch, seed)
    g = _gen(torch, seed + 1)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    full = [torch.zeros((FOLD_STEPS + 1, *t.shape[1:]), device="cuda")
            for t in period]
    src_rows = [randn((FOLD_STEPS, *t.shape[1:])) for t in period]
    gacc = {f"w{i}": randn(t.shape) for i, t in enumerate(period)}
    dp = {f"w{i}": randn(t.shape) for i, t in enumerate(period)}
    gacc.update(bf16=randn((3001,), torch.bfloat16), mixed=randn((777,)),
                fresh=torch.zeros((), device="cuda").expand(4097),
                unread=randn((5,)))
    dp.update(bf16=randn((3001,), torch.bfloat16),
              mixed=randn((777,), torch.bfloat16), fresh=randn((4097,)),
              unread=torch.zeros((), device="cuda").expand(5))
    # a short tail chunk's cotangent, added after the chunk's (chunk 0's
    # launch), for the small leaves
    tail = {k: (randn(v.shape, v.dtype) if k in ("bf16", "mixed", "fresh")
                else torch.zeros((), device="cuda").expand(v.shape))
            for k, v in dp.items()}
    del period
    return gacc, [dp, tail], full, lambda fs: [f[1:] for f in fs], src_rows


def check_fold(torch) -> None:
    """``fold`` bit for bit against its plain version (the same IEEE adds
    in the same order, and copies) at gemma2-2b's main-path chunk and at
    the synthetic case that takes the kernel's add branches."""
    from repro_torch.api.chain import is_broadcast_zero
    from repro_torch.kernels import segment_generic as sg

    for label, case in (("gemma2-2b's main-path chunk", generic_fold_chunk),
                        ("the synthetic add case", generic_fold_case)):
        gacc, dps, full, rows, src_rows = case(torch)
        ref_acc = {k: v if is_broadcast_zero(v) else v.clone()
                   for k, v in gacc.items()}
        ref_full = [f.clone() for f in full]
        acc, ops = sg.fold_plan(ref_acc, dps, rows(ref_full), src_rows)
        sg.fold_plain(ops)
        got = sg.fold(gacc, dps, rows(full), src_rows)
        torch.cuda.synchronize()
        want = dict(zip(ref_acc, acc))
        require(all(_bits_equal(torch, got[k], want[k]) for k in want)
                and all(_bits_equal(torch, a, b)
                        for a, b in zip(full, ref_full)),
                f"fold: not bit for bit its plain version at {label}")
        nbytes = sum(t.numel() * t.element_size() for t in src_rows)
        log(f"[kernels] fold at {label} ({len(src_rows)} input-cotangent "
            f"rows, {nbytes:,} B, {len(want)} accumulator leaves): bit for "
            "bit its plain version")
        del gacc, dps, full, src_rows, ref_acc, ref_full, ops
        torch.cuda.empty_cache()


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
    check_entry_store(torch)
    check_fold(torch)
    torch.cuda.empty_cache()
    # the layer kernels of gemma2-2b's body (the error kept: the bf16 main
    # path's shapes)
    bwd = [check_flash_bwd(torch, *case, seed=80 + i)
           for i, case in enumerate(FLASH_BWD_CASES)]
    check_flash_bwd_refused(torch)
    layer_errs = check_layer_kernels(torch)
    # mamba2-370m's body (the SSD backward, the conv, the step sizes, the
    # gated norm)
    ssd_bwd = [check_ssd_bwd(torch, *case, seed=90 + i)
               for i, case in enumerate(SSD_BWD_CASES)]
    mamba_errs = check_mamba_layer_kernels(torch)
    # the projections of both bodies
    dense_errs = check_dense(torch)
    # phi3.5-moe's MoE layer
    moe_errs = check_moe(torch)
    # the bodies' glue inside the kernels (the residual epilogues, the
    # fan-out and skip sums, the rope's angles, mamba2's split, the aux)
    glue_errs = check_glue(torch)
    # the flash kernel's shapes on the main path: gemma2-2b's, phi3.5-moe's
    state["err"] = {"lstm_cell": max(errs["torch.float32"], loop),
                    "fused_advance_segment": max(adv, adv1, adv_pinned),
                    "fused_reverse_segment": max(rev, rev1, rev_pinned),
                    "flash_attention": max(flash[0], flash[2]),
                    "ssd_scan": ssd[0],
                    # bit for bit, or the phase has failed
                    "entry_store": 0.0, "fold": 0.0,
                    "flash_attention_bwd": max(bwd[0], bwd[2], bwd[4]),
                    "ssd_scan_bwd": ssd_bwd[0],
                    **layer_errs, **mamba_errs, **dense_errs, **moe_errs}
    for name, e in glue_errs.items():
        state["err"][name] = max(state["err"].get(name, 0.0), e)


def _mixer_case(torch, rng, cfg, B, T):
    """mamba2's mixer inputs at ``cfg``'s widths: ``zxbcdt`` (B, T, d_proj)
    bf16, the layer's parameters (init_mamba2's scales) and the output's
    cotangent."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H, gn = d_inner // s.headdim, s.ngroups * s.d_state
    C = d_inner + 2 * gn
    bf16, f32 = torch.bfloat16, torch.float32
    zx = _randn(torch, rng, (B, T, 2 * d_inner + 2 * gn + H), bf16)
    p = {"conv_w": _randn(torch, rng, (s.conv_k, C), f32, 0.2),
         "conv_b": _randn(torch, rng, (C,), f32, 0.1),
         "dt_bias": _randn(torch, rng, (H,), f32, 0.5),
         "A_log": _randn(torch, rng, (H,), f32, 0.5),
         "D": _randn(torch, rng, (H,), f32),
         "norm_scale": _randn(torch, rng, (d_inner,), f32, 0.3)}
    return zx, p, _randn(torch, rng, (B, T, d_inner), bf16)


def mixer_grads(torch, zx0, p0, cot, cfg, composed):
    """mamba2's mixer (``ssm._Mixer``: the split owned, each backward
    kernel writing its columns of one cotangent) or (``composed``) the same
    kernels' separate autograd functions over the split's slices and
    ``torch.cat``, as the block ran them before: ``(output, d zxbcdt,
    every parameter's gradient)``."""
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.models import ssm

    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    B, T = zx0.shape[:2]
    G, N, hd = s.ngroups, s.d_state, s.headdim
    bf = torch.bfloat16
    zx = zx0.detach().clone().requires_grad_(True)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    A = -torch.exp(p["A_log"].float())
    w, b = p["conv_w"].to(bf), p["conv_b"].to(bf)
    if composed:
        z, xi, Bc, Cc, dt_raw = ssm._split_proj(zx, d_inner, G, N,
                                                d_inner // hd)
        conv, _ = cc.conv_silu(torch.cat([xi, Bc, Cc], dim=-1), w, b)
        xh = conv[..., :d_inner].reshape(B, T, -1, hd)
        Bg = conv[..., d_inner:d_inner + G * N].reshape(B, T, G, N)
        Cg = conv[..., d_inner + G * N:].reshape(B, T, G, N)
        dts = ds.softplus_dt(dt_raw, p["dt_bias"])
        y, _ = ssm.ssd_chunked(xh, dts, A, Bg, Cg, chunk=s.chunk)
        out = gn.gated_norm_out(y, xh, p["D"], z, p["norm_scale"],
                                out_dtype=bf)
    else:
        out, _ = ssm._Mixer.apply(zx, w, b, p["dt_bias"], A, p["D"],
                                  p["norm_scale"], None, None,
                                  (d_inner, G, N, hd, s.chunk, bf))
    leaves = [zx] + [p[k] for k in sorted(p)]
    grads = torch.autograd.grad(out, leaves, cot)
    return (out.detach(),) + grads


def check_glue(torch) -> dict:
    """The bodies' glue moved into the kernels, at the main path's shapes
    in bf16, each form two calls bit for bit and bit for bit what it
    replaces: ``dense_fwd``'s residual epilogue (gemma2-2b's ``wo``,
    mamba2-370m's ``out_proj``) against the product plus PyTorch's add;
    ``rmsnorm_bwd`` with three consumers' cotangents and the skip's
    (gemma2-2b's ln1) against it on their sum (each add rounded) plus the
    skip's add, and against the plain version at ``GRAD_TOL``; the rope by
    theta (gemma2-2b's q and k) against the plain version on the table at
    ``GRAD_TOL``; mamba2-370m's mixer (the conv reading its columns in
    place and writing x, B, C apart, the step sizes' and gated norm's
    backwards into their columns, the conv's from the SSD's pieces with
    the skip's addend) against the same kernels over the split's slices
    and ``torch.cat`` (the output and the parameters' gradients bit for
    bit, ``zxbcdt``'s equal: a -0.0 the slices' zero fill made +0.0 stays
    -0.0); phi3.5-moe's combine with the residual, the dispatch backward
    with the gate's and up's cotangents, the routing's aux loss (on its
    own choices, 1e-5 of the plain ``aux_plain``, a running total's sum
    bit for bit).  Returns the max abs error of each kernel against its
    plain version."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import dense as dn
    from repro_torch.kernels import moe as mk
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.models.layers import rope_table
    from repro_torch.models.moe import _capacity

    rng = np.random.default_rng(78)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}

    def same_bits(name, label, got, want, same, values_only=()):
        ok = same and all(
            (torch.equal(a, b) if i in values_only
             else _bits_equal(torch, a, b))
            for i, (a, b) in enumerate(zip(got, want)))
        require(ok, f"{name} {label}: not bit for bit the form it replaces,"
                f" or two calls differ ({not same})")
        log(f"[kernels] {name} {label}: bit for bit the form it replaces; "
            "two calls bit for bit")

    for label, (M, K, N) in (("gemma2-2b wo", (8192, 2048, 2304)),
                             ("mamba2-370m out_proj", (16384, 2048, 1024))):
        x = _randn(torch, rng, (M, K), bf16)
        w = _randn(torch, rng, (K, N), f32, K ** -0.5)
        res = _randn(torch, rng, (M, N), bf16)
        (y,), same = _twice_equal(torch, lambda: (dn.dense_fwd(x, w, res),))
        same_bits("dense_fwd", f"{label} with the residual", [y],
                  [res + dn.dense_fwd(x, w)], same)
        del x, w, res, y
    scale = _randn(torch, rng, (GEMMA_D,), f32, 0.3)
    x = _randn(torch, rng, (2, 4096, GEMMA_D), bf16)
    gs = [_randn(torch, rng, x.shape, bf16) for _ in range(3)]
    dskip = _randn(torch, rng, x.shape, bf16)
    _, rstd = rn.rmsnorm(x, scale, out_dtype=bf16)
    got, same = _twice_equal(torch, lambda: rn.rmsnorm_bwd(
        gs[0], x, scale, rstd, g_more=gs[1:], dskip=dskip))
    g = (gs[0] + gs[1]) + gs[2]
    dx, dsc = rn.rmsnorm_bwd(g, x, scale, rstd)
    same_bits("rmsnorm_bwd", "three consumers and the skip (gemma2-2b ln1)",
              got, [dx + dskip, dsc], same)
    want = rn.rmsnorm_bwd_plain(g, x, scale, 1e-6, bf16)
    want = (want[0] + dskip, want[1])
    e = max(scaled_err(a, b) for a, b in zip(got, want))
    require(e <= GRAD_TOL["layers"]["bfloat16"],
            f"rmsnorm_bwd with the fan-out and the skip: scaled error {e} "
            "from the plain version")
    errs["rmsnorm_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
    del x, gs, dskip, rstd, got, g, dx, dsc, want
    gemma = get_config("gemma2-2b")
    cos, sin = rope_table(4096, 256, gemma.rope_theta, device="cuda")
    qk = [_randn(torch, rng, sh, bf16) for sh in GEMMA_QK]
    for name, fn, plain in (
            ("rope", rope_mod.rope,
             lambda t: rope_mod.rope_plain(t, cos, sin)),
            ("rope_bwd", rope_mod.rope_bwd,
             lambda t: rope_mod.rope_bwd_plain(t, t, cos, sin))):
        got, same = _twice_equal(torch, lambda: fn(
            qk, None, None, theta=gemma.rope_theta))
        pairs = [(y, plain(t)) for t, y in zip(qk, got)]
        e = max(scaled_err(a, b) for a, b in pairs)
        tab = max(max_err(a, b) for a, b in zip(got, fn(qk, cos, sin)))
        require(same and e <= GRAD_TOL["layers"]["bfloat16"],
                f"{name} by theta: scaled error {e} from the plain version "
                f"on the table, or two calls differ ({not same})")
        errs[name] = max(max_err(a, b) for a, b in pairs)
        log(f"[kernels] {name} by theta={gemma.rope_theta} (gemma2-2b's q "
            f"and k, bf16): scaled error {e:.3g} from the plain version on "
            f"the table (gate {GRAD_TOL['layers']['bfloat16']}), max abs "
            f"err {errs[name]:.3g}; from the kernel on the table {tab:.3g}; "
            "two calls bit for bit")
    del qk, cos, sin
    torch.cuda.empty_cache()
    mamba = get_config("mamba2-370m")
    zx, p, cot = _mixer_case(torch, rng, mamba, *CARRIES["mamba2-370m"][:2])
    got, same = _twice_equal(torch, lambda: mixer_grads(
        torch, zx, p, cot, mamba, composed=False))
    want = mixer_grads(torch, zx, p, cot, mamba, composed=True)
    same_bits("mamba2 mixer", "(causal_conv, dt_softplus, ssd_scan, "
              "gated_norm and their backwards owning the split; "
              "mamba2-370m's layer)", got, want, same, values_only=(1,))
    del zx, p, cot, got, want
    torch.cuda.empty_cache()
    G, S, d, E, k, f = MOE_LAYER
    x = _randn(torch, rng, (G, S, d), bf16)
    w = _randn(torch, rng, (d, E), f32, d ** -0.5)
    aux_in = torch.tensor(0.25, device="cuda")
    (weights, idx, probs, aux, ce), same = _twice_equal(
        torch, lambda: mk.moe_route(x, w, k, aux_in=aux_in))
    base = mk.moe_route(x, w, k)[3]
    want = mk.aux_plain(probs, idx, E)
    e = scaled_err(base, want)
    require(same and e <= 1e-5 and _bits_equal(torch, aux, aux_in + base),
            f"moe_route's aux: {e} from the plain version on its choices, "
            f"or the running total's sum not bit for bit, or two calls "
            f"differ ({not same})")
    errs["moe_route"] = max_err(base, want)
    log(f"[kernels] moe_route's aux loss (phi3.5-moe's layer): {float(base)}"
        f", scaled error {e:.3g} from the plain version on its choices; the "
        "running total's sum bit for bit; two calls bit for bit")
    C = _capacity(S, E, k, MOE_CFS[0])
    choice_slot, slot_src, _ = mk.moe_slots(idx, E, C)
    rows = _randn(torch, rng, (E, G * C, d), bf16)
    res = _randn(torch, rng, (G, S, d), bf16)
    (y,), same = _twice_equal(torch, lambda: (mk.moe_combine(
        rows, weights, choice_slot, bf16, res),))
    same_bits("moe_combine", "with the residual (phi3.5-moe's layer)", [y],
              [res + mk.moe_combine(rows, weights, choice_slot, bf16)], same)
    dexp2 = _randn(torch, rng, rows.shape, bf16)
    (dx,), same = _twice_equal(torch, lambda: (mk.moe_dispatch_bwd(
        rows, choice_slot, dexp2),))
    same_bits("moe_dispatch_bwd", "from the gate's and up's cotangents",
              [dx], [mk.moe_dispatch_bwd(rows + dexp2, choice_slot)], same)
    del x, w, weights, idx, probs, rows, res, y, dexp2, dx
    torch.cuda.empty_cache()
    return errs


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


def _alloc_counts(torch):
    """Page-locked host allocations and device mallocs made so far (the
    caching allocators' ``num_host_alloc`` and ``num_device_alloc``), and
    the device segments allocated in the small and the large pool."""
    host = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    dev = torch.cuda.memory_stats()
    return (host.get("num_host_alloc", -1), dev.get("num_device_alloc", -1),
            dev.get("segment.small_pool.allocated", -1),
            dev.get("segment.large_pool.allocated", -1))


MAIN_COUNTERS = ("advances", "backwards", "l2_stores", "host_dispatches",
                 "fused_segments", "fused_boundary_copies", "l2_peak_bytes")


def warm_call(vg, params, batch, captured: bool) -> dict:
    """One warm fused gradient (the schedule cached), captured or through
    the uncaptured wrappers (``segment_fused._CAPTURED``, the private
    switch): its wall, result, counters, launches and the allocations it
    made."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import segment_fused as sf

    sf._CAPTURED = captured
    try:
        before, a0 = _fused_counts(), _alloc_counts(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a1, now = _alloc_counts(torch), _fused_counts()
    finally:
        sf._CAPTURED = True
    launches = {k: v - before[0][k] for k, v in now[0].items()}
    cells = {k: (v[0] - before[1][k][0], v[1] - before[1][k][1])
             for k, v in now[1].items()}
    return {"loss": loss, "grads": grads, "wall": wall,
            "stats": api.last_stats(), "plan": api.last_plan(),
            "tune": api.last_tune(), "launches": launches, "cells": cells,
            "host_allocs": a1[0] - a0[0], "device_mallocs": a1[1] - a0[1],
            "device_segments": (a1[2] - a0[2], a1[3] - a0[3])}


def check_captured_equal(label, cap, ref) -> None:
    """A captured warm call against the uncaptured one: loss and every
    gradient leaf bit for bit, the plan, the counters and every launch
    count equal."""
    import torch

    require(cap["plan"].plan_id == ref["plan"].plan_id,
            f"{label}: plans differ ({cap['plan'].plan_id}, "
            f"{ref['plan'].plan_id})")
    require(torch.equal(cap["loss"], ref["loss"])
            and all(torch.equal(cap["grads"][k], ref["grads"][k])
                    for k in ref["grads"]),
            f"{label}: the captured gradient is not bit for bit the "
            "uncaptured one")
    diff = {n: (getattr(cap["stats"], n), getattr(ref["stats"], n))
            for n in MAIN_COUNTERS
            if getattr(cap["stats"], n) != getattr(ref["stats"], n)}
    require(not diff, f"{label}: counters differ (captured, uncaptured): "
            f"{diff}")
    require(cap["launches"] == ref["launches"]
            and cap["cells"] == ref["cells"],
            f"{label}: launches {cap['launches']} {cap['cells']} against "
            f"the uncaptured {ref['launches']} {ref['cells']}")


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
        captures = sf.CapturedRun.captures
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
        if label == "autotuned":
            # what phase scan holds the scan engine to
            state["main_result"] = (loss.cpu(),
                                    {k: g.cpu() for k, g in grads.items()})
        segs = plan.num_segments
        log(f"[main] {label}: tune I={tune.interval} s={tune.slots} "
            f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); "
            f"plan {plan.plan_id} ({segs} segments)")
        log(f"[main] {label}: first call (captures "
            f"{sf.CapturedRun.captures - captures} graphs): loss "
            f"{float(loss):.6f} (rel err {rel:.3g}), grad scaled err "
            f"{gerr:.3g}; wall {wall:.3f}s; launches {grew}")
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
        del loss, grads
        # warm calls, captured and uncaptured in turns, in this process
        captures = sf.CapturedRun.captures
        warm = []
        for captured in (True, False, True):
            w = warm_call(vg, params, batch, captured)
            _check_against(label, w["loss"], w["grads"], ref_loss,
                           ref_grads)
            # compared on the host from here on: the card's copies go back
            # to the caching allocator before the next call
            w["loss"] = w["loss"].cpu()
            w["grads"] = {k: g.cpu() for k, g in w["grads"].items()}
            warm.append(w)
        for name, w in zip(("captured", "uncaptured", "captured again"),
                           warm):
            log(f"[main] {label}: warm {name} call: wall {w['wall']:.4f}s "
                f"({1e3 * w['wall'] / segs:.4f} ms a segment); page-locked "
                f"host allocations {w['host_allocs']}, device mallocs "
                f"{w['device_mallocs']} (segments small, large pool "
                f"{w['device_segments']}); store_stall_s="
                f"{w['stats'].store_stall_s:.4f} prefetch_stall_s="
                f"{w['stats'].prefetch_stall_s:.4f}")
        check_captured_equal(label, warm[0], warm[1])
        check_captured_equal(label, warm[2], warm[1])
        pool = next(iter(sf._POOLS.values()))
        log(f"[main] {label}: captured warm calls bit for bit the "
            f"uncaptured one, counters and launches equal; graphs captured "
            f"in the warm calls {sf.CapturedRun.captures - captures}; "
            f"Level-2 slot pool {pool.size} slots of {pool.slot_bytes} B "
            f"(grown {pool.grown}, {pool.free} free)")
        require(sf.CapturedRun.captures == captures,
                f"{label}: a warm call captured graphs again")
        for w in (warm[0], warm[2]):
            require(w["host_allocs"] == 0 and w["device_mallocs"] == 0,
                    f"{label}: a warm captured call allocated (page-locked "
                    f"{w['host_allocs']}, device {w['device_mallocs']})")
        runs.append({"label": label, "interval": tune.interval,
                     "slots": tune.slots, "t_a": tune.t_a, "t_t": tune.t_t,
                     "wall_s": wall, "warm_s": warm[0]["wall"],
                     "warm_uncaptured_s": warm[1]["wall"],
                     "l2_peak_bytes": stats.l2_peak_bytes,
                     "l1_peak_device_bytes": l1_peak})
        del warm
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


# phase scan: the pinned run's interval, and the shorter chain the device
# peak is held flat against
SCAN_I = 64
SCAN_HALF_T = 2048


def scan_call(vg, params, batch) -> dict:
    """One scan-engine gradient: its result, wall, device peak above what
    was allocated before it, ``lstm_cell`` launches and what its
    boundaries moved (``api.last_scan()``)."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import lstm_cell as lc

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = lc.lstm_cell.launches
    t0 = time.perf_counter()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"loss": loss, "grads": grads, "wall": wall,
            "peak": torch.cuda.max_memory_allocated() - base, "base": base,
            "launches": lc.lstm_cell.launches - launches,
            "record": api.last_scan(), "tune": api.last_tune(),
            "plan": api.last_plan(), "stats": api.last_stats()}


def scan_steps_run(plan, tune) -> int:
    """Chain steps one scan-engine gradient runs: each step forward, each
    step again in its segment's recompute (twice in a segment recomputed in
    inner chunks: the chunks' forward, then each chunk's recompute), and
    the autotune probe's steps."""
    recompute = sum(seg.length * (2 if plan.inner_chunk(seg) else 1)
                    for seg in plan.segments)
    return plan.n + recompute + tune.probe_calls * tune.probe_len


def check_scan_run(label, run, n) -> None:
    """A scan-engine run's plan, record and counters: the plan is
    ``segment_plan(n, I, s)`` of its schedule, no executor ran
    (``last_stats()`` is None), and each segment offloaded one boundary,
    into page-locked memory."""
    from repro_torch.core import schedule as ms

    tune, plan, rec = run["tune"], run["plan"], run["record"]
    want = ms.segment_plan(n, tune.interval, tune.slots)
    require(plan.plan_id == want.plan_id,
            f"{label}: last_plan() {plan.plan_id}, the schedule gives "
            f"{want.plan_id}")
    require(run["stats"] is None, f"{label}: last_stats() is set after a "
            "scan call")
    require(rec.segments == rec.boundaries_offloaded == rec.pinned_boundaries
            == plan.num_segments,
            f"{label}: {rec.boundaries_offloaded} boundaries offloaded "
            f"({rec.pinned_boundaries} page-locked) for "
            f"{plan.num_segments} segments")
    require(rec.prefetches + rec.demand_loads == plan.num_segments,
            f"{label}: {rec.prefetches} uploads ahead and "
            f"{rec.demand_loads} on demand for {plan.num_segments} segments")


def log_scan_run(key, label, run) -> None:
    tune, plan, rec = run["tune"], run["plan"], run["record"]
    log(f"[{key}] {label}: tune I={tune.interval} s={tune.slots} "
        f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s ({tune.source}); plan "
        f"{plan.plan_id} ({plan.num_segments} segments)")
    log(f"[{key}] {label}: wall {run['wall']:.4f}s; device peak "
        f"{run['peak']:,} B above the {run['base']:,} B held before the "
        f"call; boundaries offloaded {rec.boundaries_offloaded} (page-locked "
        f"{rec.pinned_boundaries}), {rec.d2h_bytes:,} B to the host, "
        f"{rec.h2d_bytes:,} B back; uploads ahead {rec.prefetches}, on "
        f"demand {rec.demand_loads}, blocked waits {rec.blocked_waits}")


def phase_scan(state) -> None:
    """``lstm-paper`` at ``train_4k`` through ``engine="scan"``: autotuned
    and pinned at I=64, each held to phase ``main``'s gates against the
    fused (``engine="compiled"``) gradient of phase ``main``; the plan, the
    boundaries (one a segment, page-locked) and the ``lstm_cell`` launches
    (one a step run: forward, recompute, probe); a warm autotuned call (a
    pinned call has no probe: its first call is warm); the device peak at
    S=4096 against S=2048 at the same I."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import lstm_cell as lc

    lstm_inputs(state)
    model, params, batch = state["model"], state["params"], state["batch"]
    if "main_result" not in state:
        # phase main did not run: its gradient, the same way
        vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                          device="cuda")
        loss, grads = vg(params, batch)
        state["main_result"] = (loss.cpu(),
                                {k: g.cpu() for k, g in grads.items()})
        del loss, grads
    ref_loss = state["main_result"][0].cuda()
    ref_grads = {k: g.cuda() for k, g in state["main_result"][1].items()}
    n = batch["tokens"].shape[1] - 1
    lc.lstm_cell.launches = 0
    total = 0
    runs = {}
    for label, kw in (("autotuned", {}), ("pinned", {"interval": SCAN_I})):
        vg = api.value_and_grad_offloaded(model.train_loss, engine="scan",
                                          device="cuda", **kw)
        first = scan_call(vg, params, batch)
        rel, gerr = _check_against(f"scan {label}", first["loss"],
                                   first["grads"], ref_loss, ref_grads)
        check_scan_run(f"scan {label}", first, n)
        want = scan_steps_run(first["plan"], first["tune"])
        require(first["launches"] == want and first["launches"] > 0,
                f"scan {label}: lstm_cell launched {first['launches']} "
                f"times, the plan implies {want}")
        log_scan_run("scan", f"{label}, first call", first)
        log(f"[scan] {label}: loss {float(first['loss']):.6f} (rel err "
            f"{rel:.3g} against phase main's fused gradient), grad scaled "
            f"err {gerr:.3g}; lstm_cell launches {first['launches']}")
        del first["loss"], first["grads"]
        total += first["launches"]
        runs[label] = {"first": first, "warm": first, "vg": vg}
        if kw:
            # a pinned schedule has no probe: its first call is warm
            continue
        warm = scan_call(vg, params, batch)
        _check_against(f"scan {label} warm", warm["loss"], warm["grads"],
                       ref_loss, ref_grads)
        check_scan_run(f"scan {label} warm", warm, n)
        require(warm["tune"].probe_calls == 0
                and warm["launches"] == scan_steps_run(warm["plan"],
                                                       warm["tune"]),
                f"scan {label}: a warm call launched lstm_cell "
                f"{warm['launches']} times")
        log_scan_run("scan", f"{label}, warm call", warm)
        del warm["loss"], warm["grads"]
        total += warm["launches"]
        runs[label]["warm"] = warm
    # the device peak does not grow with the chain: I=64 over the first
    # half of the same tokens (a view: the batch is in both baselines)
    pinned = runs["pinned"]["warm"]
    half = {"tokens": batch["tokens"][:, :SCAN_HALF_T + 1]}
    short = scan_call(runs["pinned"]["vg"], params, half)
    check_scan_run("scan pinned S=2048", short, SCAN_HALF_T)
    require(math.isfinite(float(short["loss"]))
            and all(bool(g.isfinite().all())
                    for g in short["grads"].values()),
            "scan pinned S=2048: non-finite loss or gradients")
    total += short["launches"]
    del short["loss"], short["grads"]
    added = n - SCAN_HALF_T
    growth = pinned["peak"] - short["peak"]
    per_k = growth / (added / 1000)
    tok = batch["tokens"]
    tok_b = tok.numel() * tok.element_size()
    log(f"[scan] device peak at I={SCAN_I}: S={n} {pinned['peak']:,} B, "
        f"S={SCAN_HALF_T} {short['peak']:,} B above what each call found "
        f"allocated; growth {growth:,} B over {added} steps = "
        f"{per_k:,.0f} B per 1,000 steps (gate < 1,000,000).  Reckoning "
        f"the tokens: the batch's {tuple(tok.shape)} {tok.dtype} tokens "
        f"({tok_b:,} B) are allocated before both calls (the S=2048 batch "
        f"is a view of them), and the chain's per-step token and target "
        f"columns are views; what a step adds inside a call is its "
        f"segment's graph node and its boundary, which is on the host")
    require(per_k < 1e6, f"scan: the device peak grew {per_k:,.0f} B per "
            "1,000 steps")
    state.setdefault("launches", {})["lstm_cell"] = \
        state.setdefault("launches", {}).get("lstm_cell", 0) + total
    state.setdefault("launches_by_phase", {})["scan"] = {"lstm_cell": total}
    log(f"[scan] lstm_cell: {total} launches in phase scan")
    state["scan"] = {k: {"interval": r["first"]["tune"].interval,
                         "wall_s": r["first"]["wall"],
                         "warm_s": r["warm"]["wall"],
                         "peak": r["warm"]["peak"],
                         "blocked": r["warm"]["record"].blocked_waits}
                     for k, r in runs.items()}
    state["scan"]["half_peak"] = short["peak"]
    del runs, ref_grads
    torch.cuda.empty_cache()



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
    within the reference's 5e-2 of its scale) and launch counts; outside
    RAM, the Level-2 slot pool holds at most the states the store keeps in
    RAM (a tiered run's budget), the prefetch depth and two more at once;
    the slow tier lives in a directory under the out-dir, removed
    afterwards."""
    import shutil

    import torch

    from repro_torch import api
    from repro_torch.core import perfmodel
    from repro_torch.core.storage import tree_bytes
    from repro_torch.kernels import segment_fused as sf

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
        pool = next(iter(sf._POOLS.values()), None)
        pool_before = held = 0
        if pool is not None:
            pool.reset_peak()
            pool_before, held = pool.size, pool.in_use
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
        pool = next(iter(sf._POOLS.values()))
        log(f"[level2] {label}: Level-2 slot pool {pool.size} slots of "
            f"{pool.slot_bytes} B ({pool_before} before the call, {held} of "
            f"them in use), at most {pool.peak - held} more in use at once; "
            f"page-locked host allocator {_host_allocator_stats(torch)}")
        if storage != "ram":
            # page-locked host memory stays within what the store keeps in
            # RAM (a tiered store's budget, none for the disk and the
            # compressed ones, which copy), the prefetch depth and two more
            kept = kw["l2_capacity_bytes"] // sb if storage == "tiered" else 0
            most = kept + stats.prefetch_depth + 2
            require(pool.peak - held <= most
                    and pool.size <= max(pool_before, held + most),
                    f"{label}: the slot pool held {pool.peak - held} slots "
                    f"at once "
                    f"and has {pool.size} ({pool_before} before), more than "
                    f"the {kept} states kept in RAM + prefetch depth "
                    f"{stats.prefetch_depth} + 2")
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
    ones (the offloaded forward sweep, probe and recompute); ``mode =
    "force"`` counts them too and then routes by the recorded choices
    instead (:func:`_forced_route`: the call's own softmax, gathered at
    those choices and renormalised, and its aux loss), so that calls that
    round elsewhere (the plain versions', an fp32 model's) take the same
    discrete decisions; ``None`` ignores the calls."""

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

        def recorded(p, xg, n_experts, top_k, aux_in=None):
            out = route(p, xg, n_experts, top_k, aux_in)
            if self.mode is not None:
                i = self._layer(p["router"]["w"].detach())
                idx = out[1].detach()
                self.calls += 1
                if self.mode == "reference":
                    self.reference[i] = idx.clone()
                else:
                    self.compared += idx.numel()
                    self.flips += int((idx != self.reference[i]).sum())
                if self.mode == "force":
                    return _forced_route(p, xg, n_experts,
                                         self.reference[i], aux_in)
            return out

        moe._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._route


def _forced_route(p, xg, n_experts, idx, aux_in=None):
    """``moe._route``'s outputs with the choices ``idx`` given: the plain
    softmax of the fp32 logits gathered at ``idx`` and renormalised, and
    the Switch aux loss of those choices (added to ``aux_in`` where
    given)."""
    import torch
    import torch.nn.functional as F

    logits = torch.einsum("gsd,de->gse", xg.float(),
                          p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    weights = probs.gather(-1, idx)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    ce = F.one_hot(idx, n_experts).float().sum(2).mean(dim=(0, 1))
    aux = n_experts * torch.sum(probs.mean(dim=(0, 1)) * ce)
    return weights, idx, aux if aux_in is None else aux_in + aux


def decoder_phase(state, key: str, arch: str, batch_size: int, kernels,
                  per_step, revolve_slots=None, tiered_states=None,
                  n_layers=None, scan=False, stream=False,
                  plans_2d=False, fused=None, fused_plain=False,
                  layer_gates=False) -> None:
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
    boundary states; with ``scan``, one ``engine="scan"`` gradient under
    the same gates; with ``stream``, one ``offload_params="moe_experts"``
    gradient, the expert weights on the host, bit for bit the first
    offloaded call's; with ``plans_2d``, the 2D calls of
    :func:`decoder_2d` at the first call's schedule; with ``fused = (I,
    slots)``, the ``runner="fused"`` gradients of :func:`decoder_fused`.
    With ``layer_gates``, the offloaded (compiled, warm and streamed)
    calls also count the body's layer kernels (:func:`layer_kernels`):
    the forward ones each time a step runs, the backward ones once a
    step's vjp."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.core import offload as ofl
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models.model_factory import get_model

    # the LSTM phases' captured graphs and workspaces (~0.7 GB at the
    # pinned shape) are not this model's: its device peaks leave them out;
    # nor are the scan engine's page-locked boundary slots
    sf.clear_caches()
    ofl.clear_pools()
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
    layer = layer_kernels(cfg) if layer_gates else {}
    counted = {**kernels, **{k: v[0] for k, v in layer.items()}}
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
        zero_launches(counted.values())
        if routing:
            routing.mode, routing.calls = "check", 0
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), wall = timed(lambda: vg(params, batch))
        launches = {k: fn.launches for k, fn in counted.items()}
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
    for name in kernels:
        n, want = launches[name], per_step[name] * (stats.advances + probe)
        require(n == want and n > 0,
                f"{key}: {name} launched {n} times, expected {want} "
                f"({per_step[name]} per step x ({stats.advances} advances "
                f"+ {probe} probe steps))")
    n_steps = sum(seg.length for seg in plan.segments)
    want = layer_launches(layer, stats.advances + probe, n_steps)
    got = {k: launches[k] for k in want}
    require(got == want and all(want.values()),
            f"{key}: layer kernels launched {got}, the plan implies {want}")
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
        zero_launches(counted.values())
        m0 = torch.cuda.memory_stats()
        (loss, grads), w = timed(lambda: vg(params, batch))
        m1 = torch.cuda.memory_stats()
        warm_walls.append(w)
        alloc.append(tuple(m1.get(k, 0) - m0.get(k, 0) for k in
                           ("num_alloc_retries", "num_device_alloc")))
        per_grad = {k: fn.launches for k, fn in counted.items()}
        advances = api.last_stats().advances
        want = {name: per_step[name] * advances for name in kernels}
        want.update(layer_launches(layer, advances, n_steps))
        require(api.last_tune().probe_calls == 0 and per_grad == want,
                f"{key}: launched {per_grad} in a warm call, expected "
                f"{want}")
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
    if scan:
        decoder_scan(state, key, model, params, batch, ref_loss, ref_grads,
                     kernels, per_step)
    if plans_2d:
        decoder_2d(state, key, model, params, batch, ref_loss, ref_grads,
                   kernels, per_step, tune)
    if fused is not None:
        decoder_fused(state, key, model, params, batch, ref_loss, ref_grads,
                      kernels, per_step, fused, layer=layer_kernels(cfg),
                      plain_gate=fused_plain, routing=routing,
                      release_ref=stream)
    if stream:
        # the reference's gradients are done with: the streamed check needs
        # the host memory they held
        require(revolve_slots is None and tiered_states is None,
                f"{key}: the streamed check runs after the last reference "
                "check")
        ref_grads = None
        _host_empty_cache()
        decoder_stream(state, key, model, params, batch, vg, plan, kernels,
                       per_step, layer)
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
                  "loss_rel": rel, "grad_err": gerr, "cfg": cfg,
                  "layer_param_bytes": sum(
                      t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params["layers"]))
                  // cfg.n_layers}
    del params, ref_grads, vg
    torch.cuda.empty_cache()
    _host_empty_cache()


def _add_launches(state, key, launches) -> None:
    """A run's launches into the kernels line's totals, and by phase."""
    total = state.setdefault("launches", {})
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    state.setdefault("launches_by_phase", {})[key] = launches


def decoder_scan(state, key, model, params, batch, ref_loss, ref_grads,
                 kernels, per_step) -> None:
    """One ``engine="scan"`` gradient of a decoder (autotuned) under its
    phase's gates: its plan, one page-locked boundary a segment, each
    kernel ``per_step`` launches a chain step run (forward, recompute,
    probe)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api

    vg = api.value_and_grad_offloaded(model.train_loss, engine="scan",
                                      device="cuda")
    zero_launches(kernels.values())
    run = scan_call(vg, params, batch)
    launches = {k: fn.launches for k, fn in kernels.items()}
    loss, grads = run["loss"], pytree.tree_leaves(run["grads"])
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(math.isfinite(float(loss))
            and all(bool(g.isfinite().all()) for g in grads),
            f"{key} scan: non-finite loss or gradients")
    gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
    require(rel <= 1e-5, f"{key} scan: loss rel err {rel} > 1e-5")
    require(gerr <= 1e-3, f"{key} scan: gradient scaled err {gerr} > 1e-3")
    check_scan_run(f"{key} scan", run, run["plan"].n)
    steps = scan_steps_run(run["plan"], run["tune"])
    for name, got in launches.items():
        want = per_step[name] * steps
        require(got == want and got > 0,
                f"{key} scan: {name} launched {got} times, expected {want}")
    log_scan_run(key, "scan engine", run)
    log(f"[{key}] scan engine: loss rel err {rel:.3g}, grad scaled err "
        f"{gerr:.3g}; launches {launches}")
    _add_launches(state, f"{key}-scan", launches)
    state[f"{key}-scan"] = {"interval": run["tune"].interval,
                            "wall_s": run["wall"], "peak": run["peak"],
                            "blocked": run["record"].blocked_waits}
    del run, grads, loss
    torch.cuda.empty_cache()


def generic_plan_work(plan, slots):
    """What a generic body's fused gradient runs for ``plan`` at ``slots``
    Level-1 slots (the runner's chunking): ``(forward chunks, reverse
    chunks, chain steps run in the reverse)``.  The reverse recomputes
    every chunk entry but the last chunk's (phase A), then runs each
    chunk once more inside its vjp; the compiled runner's checkpointed vjp
    runs every step twice when it chunks."""
    from repro_torch.core.schedule import chunk_length
    from repro_torch.kernels.segment_fused import (forward_bounds,
                                                   reverse_layout)

    fwd = rev = steps = 0
    for seg in plan.segments:
        L = seg.length
        chunk = chunk_length(L, slots) or L
        c, nc, _ = reverse_layout(L, chunk)
        fwd += len(forward_bounds(L, chunk)) - 1
        rev += nc
        steps += (nc - 1) * c + L
    return fwd, rev, steps


def _carry_bytes(model, params, batch) -> int:
    import torch
    from torch.utils import _pytree as pytree

    with torch.no_grad():
        carry0, _ = model.train_loss.chain_spec.prelude(params, batch)
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(carry0))


def layer_kernels(cfg) -> dict:
    """The layer kernels a decoder's chain body launches, by name: ``(wrapper,
    launches each time a chain step runs, launches a chain step in the
    reverse's vjp, launches a gradient outside the chain)``.  A step is one
    period of ``cfg.layer_pattern``; the norms are ln1 and, with an MLP or
    MoE, ln2, each with its post-norm where the model has them (the
    residual add inside its kernel); outside the chain, the readout's final
    norm once each way.  A mamba layer (``mamba``, ``mamba_moe``) runs the
    conv, the step sizes and the gated norm once each way and the SSD's
    backward once in the vjp (its forward, ``ssd_scan``, is the phase's
    ``kernels``).  The projections (``dense``): q, k, v and o an attention
    layer, gate, up and down an MLP or a shared expert, in and out a mamba
    layer, each with one backward call in the vjp; outside the chain, a
    VLM's patch projection.  A MoE layer (``attn_moe``, ``mamba_moe``) runs
    the routing kernel, the experts' three products (``expert_fwd``) and
    their SwiGLU (``glu``) each time it runs, their backwards once in the
    vjp, and with ``moe_impl="einsum"`` the slots, the dispatch and the
    combine (the slots forward only); a shared expert is an MLP.  Kernels a
    body does not launch are left out."""
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dense as dn
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.kernels import glu as glu_mod
    from repro_torch.kernels import moe as mk
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.kernels import ssd_scan as ssd

    post = 2 if cfg.use_post_norm else 1
    attn = sum(k.startswith("attn") for k in cfg.layer_pattern)
    mlp = sum(k in ("attn", "attn_local") for k in cfg.layer_pattern)
    norms = sum(post * (2 if k in ("attn", "attn_local", "attn_moe",
                                   "mamba_moe") else 1)
                for k in cfg.layer_pattern)
    mamba = sum(k.startswith("mamba") for k in cfg.layer_pattern)
    moe = sum(k.endswith("_moe") for k in cfg.layer_pattern) \
        if cfg.moe is not None else 0
    shared = moe if moe and cfg.moe.shared_expert else 0
    gather = moe if cfg.moe_impl == "einsum" else 0
    proj = 4 * attn + 3 * (mlp + shared) + 2 * mamba
    glu = mlp + moe + shared
    patch = 1 if cfg.family == "vlm" else 0
    table = {"flash_attention_bwd": (fa.flash_attention_bwd, 0, attn, 0),
             "rmsnorm": (rn.rmsnorm, norms, 0, 1),
             "rmsnorm_bwd": (rn.rmsnorm_bwd, 0, norms, 1),
             "glu": (glu_mod.glu, glu, 0, 0),
             "glu_bwd": (glu_mod.glu_bwd, 0, glu, 0),
             "rope": (rope_mod.rope, attn, 0, 0),
             "rope_bwd": (rope_mod.rope_bwd, 0, attn, 0),
             "ssd_scan_bwd": (ssd.ssd_scan_bwd, 0, mamba, 0),
             "causal_conv": (cc.causal_conv, mamba, 0, 0),
             "causal_conv_bwd": (cc.causal_conv_bwd, 0, mamba, 0),
             "dt_softplus": (ds.dt_softplus, mamba, 0, 0),
             "dt_softplus_bwd": (ds.dt_softplus_bwd, 0, mamba, 0),
             "gated_norm": (gn.gated_norm, mamba, 0, 0),
             "gated_norm_bwd": (gn.gated_norm_bwd, 0, mamba, 0),
             "dense_fwd": (dn.dense_fwd, proj, 0, patch),
             "dense_bwd": (dn.dense_bwd, 0, proj, patch),
             "moe_route": (mk.moe_route, moe, 0, 0),
             "moe_route_bwd": (mk.moe_route_bwd, 0, moe, 0),
             "moe_slots": (mk.moe_slots, gather, 0, 0),
             "moe_dispatch": (mk.moe_dispatch, gather, 0, 0),
             "moe_dispatch_bwd": (mk.moe_dispatch_bwd, 0, gather, 0),
             "moe_combine": (mk.moe_combine, gather, 0, 0),
             "moe_combine_bwd": (mk.moe_combine_bwd, 0, gather, 0),
             "expert_fwd": (dn.expert_fwd, 3 * moe, 0, 0),
             "expert_bwd": (dn.expert_bwd, 0, 3 * moe, 0)}
    return {k: v for k, v in table.items() if any(v[1:])}


def layer_launches(layer, run_steps, vjp_steps) -> dict:
    """Each layer kernel's launches in one gradient that runs
    ``run_steps`` chain steps forward (sweep, recompute, probe) and
    ``vjp_steps`` steps' vjps."""
    return {k: f * run_steps + b * vjp_steps + once
            for k, (_, f, b, once) in layer.items()}


def zero_launches(fns, plain=False) -> None:
    """Every launch count in ``fns`` to 0 just before a measured call.  A
    main-path call must find the model wrappers routed to their kernels
    (``build.on_card`` the module's own function, no patch left in
    place); a call inside :class:`_PlainVersions` passes ``plain``."""
    from repro_torch.kernels import build

    f = build.on_card
    own = f.__module__ == build.__name__ and f.__name__ == "on_card"
    require(own != plain,
            f"build.on_card is {f!r}: the call would run "
            f"{'the kernels' if own else 'the plain versions'}, expected "
            f"{'the plain versions' if plain else 'the kernels'}")
    for fn in fns:
        fn.launches = 0


class _PlainVersions:
    """Every model-level kernel wrapper (``build.on_card``: the flash
    forward and backward, rmsnorm, glu, rope, the projections' GEMM, the
    SSD scan and its backward, the causal conv, the step sizes, the gated
    norm, the LSTM cell, and the MoE layer: its routing, and in
    ``moe_einsum`` the one-hot einsums in place of the slots, dispatch,
    experts' products and combine) takes its plain PyTorch version on CUDA
    tensors too: the reference the kernels are held against.  The generic
    segments' data movement (``entry_store``, ``fold``) is unchanged: bit
    for bit its plain version anyway."""

    def __enter__(self):
        from repro_torch.kernels import build

        self._on_card, build.on_card = build.on_card, lambda t: False
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import build

        build.on_card = self._on_card


def fused_against_plain(key, cfg, call, fused, interval, slots,
                        paths) -> dict:
    """The fused gradient of the kernels (``fused``, at ``(interval,
    slots)``) against the same call through the plain versions
    (:class:`_PlainVersions`), the referee an fp32-compute gradient through
    the plain versions: the loss within 3e-2, and each leaf's scaled
    distance from the fp32 gradient at most 3e-2 above the plain bf16
    gradient's (phase ``families``' bf16 gate: two bf16 gradients 26
    layers deep differ by more than 3e-2 between themselves).  The plain
    call runs twice (the second's wall is the warm one); walls and device
    peaks are logged.  A MoE model's plain and fp32 calls are routed by the
    kernels' choices (``call`` forces them): a routing choice is discrete,
    and the bf16 and fp32 paths round the router's input differently, so
    unforced the gate would compare routings, not arithmetic; the choices
    the plain call would have made otherwise are counted and logged."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import DTypes
    from repro_torch.models.model_factory import get_model

    kern = _to_host(torch, fused["grads"])
    fused["grads"] = None
    torch.cuda.empty_cache()
    with _PlainVersions():
        first = call("fused", interval=interval, slots=slots, plain=True)
        del first
        plain = call("fused", interval=interval, slots=slots, plain=True)
        model_launches = {k: n for k, n in plain["launches"].items()
                          if k not in ("entry_store", "fold")}
        require(not any(model_launches.values()),
                f"{key}: the plain versions' call launched {model_launches}")
        plain_grads = _to_host(torch, plain.pop("grads"))
        torch.cuda.empty_cache()
        if plain["routing"] is not None:
            calls, compared, flips = plain["routing"]
            log(f"[{key}] routing of the plain versions' call: its own "
                f"choices differ from the kernels' (the reference "
                f"forward's) in {flips} of {compared} top-{cfg.moe.top_k} "
                f"choices ({calls} MoE layer applications): its router "
                "sums the logits in cuBLAS's order, and from the second "
                "layer on its input was rounded elsewhere in bf16 (the "
                "attention's, norms' and projections' plain versions); it "
                "and the fp32 referee are routed by the kernels' choices "
                "(_RoutingRecorder's force mode), so the gate compares "
                "their arithmetic")
        # the chain fixes its compute dtype when it is built: an fp32 model
        dts = tfm._dtypes
        tfm._dtypes = lambda c: DTypes(compute=torch.float32)
        try:
            model32 = get_model(cfg)
        finally:
            tfm._dtypes = dts
        ref = call("fused", loss_fn=model32.train_loss, interval=interval,
                   slots=slots, plain=True)
    loss, p_loss = float(fused["loss"]), float(plain["loss"])
    rel = abs(loss - p_loss) / abs(p_loss)
    dist = []   # (kernels' - plain's distance, path, kernels', plain's,
    #             kernels' from plain's)
    for a, b, r, pth in zip(kern, plain_grads, ref["grads"], paths):
        a, b = a.to(r.device), b.to(r.device)
        ek, ep = scaled_err(a, r), scaled_err(b, r)
        dist.append((ek - ep, pth, ek, ep, scaled_err(a, b)))
        del a, b
    dist.sort(reverse=True)
    worst, worst_at = dist[0][0], dist[0][1]
    e_k, e_p = [d[2] for d in dist], [d[3] for d in dist]
    log(f"[{key}] leaves farthest above the plain versions' distance from "
        "the fp32 gradient (kernels', plain's, kernels' from plain's): "
        + "; ".join(f"{pth} {ek:.4g} {ep:.4g} {kp:.4g}"
                    for _, pth, ek, ep, kp in dist[:6]))
    require(rel <= 3e-2 and worst <= 3e-2,
            f"{key}: kernels against the plain versions: loss rel err {rel};"
            f" at {worst_at} the kernels' gradient's scaled distance "
            f"from the fp32 one exceeds the plain versions' by {worst} "
            "(gate 3e-2)")
    r_loss = float(ref["loss"])
    require(r_loss != p_loss, f"{key}: the fp32 referee's loss is the plain "
            "bf16 call's: it did not compute in fp32")
    log(f"[{key}] fused I={interval} s={slots}, kernels against the plain "
        f"versions: loss {loss:.6f} against {p_loss:.6f} (rel err "
        f"{rel:.3g}; fp32 referee {r_loss:.6f}); scaled "
        f"distance from the fp32 gradient, worst leaf: kernels "
        f"{max(e_k):.4g}, plain {max(e_p):.4g}; the kernels' less the "
        f"plain's at most {worst:.4g} ({worst_at}; gate 3e-2)")
    log(f"[{key}] warm walls: kernels {fused['wall']:.3f}s, plain versions "
        f"{plain['wall']:.3f}s, fp32 referee {ref['wall']:.3f}s; device "
        f"peaks above held: kernels {fused['peak']:,} B, plain versions "
        f"{plain['peak']:,} B, fp32 referee {ref['peak']:,} B")
    out = {"loss_rel": rel, "worst": worst, "kern_wall": fused["wall"],
           "plain_wall": plain["wall"], "kern_peak": fused["peak"],
           "plain_peak": plain["peak"]}
    del ref, kern, plain_grads
    torch.cuda.empty_cache()
    return out


def decoder_fused(state, key, model, params, batch, ref_loss, ref_grads,
                  kernels, per_step, pinned, layer=None,
                  plain_gate=False, routing=None, release_ref=False) -> None:
    """``runner="fused"`` on a decoder (a generic chain body: its steps as
    PyTorch code, the chunk-entry stores and the cotangent fold by the
    ``entry_store`` and ``fold`` kernels), under the phase's gates against
    dense autograd: autotuned (a first and a second call), then at
    ``pinned = (I, slots)`` beside a
    ``runner="compiled"`` gradient at that schedule, which it must match
    bit for bit in the loss, with the same plan and a device peak (above
    what each call found allocated) at most two carries above the compiled
    one's.  Each call's launches: ``entry_store`` once a forward chunk
    (the probe's included), ``fold`` once a reverse chunk, each model
    kernel ``per_step`` a chain step run (``generic_plan_work``); and
    ``fused_segments``, ``fused_boundary_copies`` as the reference counts
    them.  Then one fused advance of the pinned schedule's first segment
    timed against the compiled advance of it.  With ``routing`` (a MoE
    model's :class:`_RoutingRecorder`, holding the reference forward's
    choices), every call's routing (forward, probe, recompute) must equal
    the reference's; the plain versions' calls (and the fp32 referee's)
    are routed by the reference's choices, the choices they would have
    made otherwise counted and logged (:func:`fused_against_plain`).
    With ``release_ref``, the caller's reference gradients (a list on the
    host) are emptied once the pinned call is gated: the plain versions'
    check holds two more gradients on the host."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.kernels import segment_generic as sg

    layer = layer or {}
    counted = {**kernels, "entry_store": sg.entry_store, "fold": sg.fold,
               **{k: v[0] for k, v in layer.items()}}

    def call(runner, loss_fn=None, plain=False, **kw):
        vg = api.value_and_grad_offloaded(loss_fn or model.train_loss,
                                          runner=runner, device="cuda", **kw)
        zero_launches(counted.values(), plain)
        if routing is not None:   # the plain calls take the kernels' routing
            routing.mode = "force" if plain else "check"
            routing.calls = routing.compared = routing.flips = 0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        route = None
        if routing is not None:
            route = (routing.calls, routing.compared, routing.flips)
            routing.mode = None
            require(plain or (route[2] == 0 and route[0] > 0),
                f"{key} {runner} {kw}: {route[2]} of {route[1]} routing "
                "choices differ from the reference forward's")
        return {"loss": loss, "grads": pytree.tree_leaves(grads),
                "wall": wall,
                "peak": torch.cuda.max_memory_allocated() - held,
                "launches": {k: fn.launches for k, fn in counted.items()},
                "stats": api.last_stats(), "plan": api.last_plan(),
                "tune": api.last_tune(), "routing": route}

    def gates(label, run, slots):
        loss, grads = run["loss"], run["grads"]
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        require(math.isfinite(float(loss))
                and all(bool(g.isfinite().all()) for g in grads),
                f"{label}: non-finite loss or gradients")
        gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
        require(rel <= 1e-5, f"{label}: loss rel err {rel} > 1e-5")
        require(gerr <= 1e-3, f"{label}: gradient scaled err {gerr} > 1e-3")
        plan, stats, tune = run["plan"], run["stats"], run["tune"]
        fwd, rev, rsteps = generic_plan_work(plan, slots)
        probe = tune.probe_calls   # one chunk each
        fwd_steps = sum(seg.length for seg in plan.segments)
        want = {"entry_store": fwd + probe, "fold": rev}
        for name in kernels:
            want[name] = per_step[name] * (fwd_steps + rsteps
                                           + probe * tune.probe_len)
        want.update(layer_launches(
            layer, fwd_steps + rsteps + probe * tune.probe_len, fwd_steps))
        require(run["launches"] == want and all(want.values()),
                f"{label}: launches {run['launches']}, the plan implies "
                f"{want}")
        require(stats.fused_segments == 2 * plan.num_segments
                and stats.fused_boundary_copies == fwd + 2 * rev,
                f"{label}: fused_segments {stats.fused_segments}, "
                f"fused_boundary_copies {stats.fused_boundary_copies} for "
                f"{plan.num_segments} segments, {fwd} forward and {rev} "
                "reverse chunks")
        log(f"[{key}] {label}: I={tune.interval} s={tune.slots} "
            f"({tune.source}), plan {plan.plan_id} ({plan.num_segments} "
            f"segments; {fwd} forward, {rev} reverse chunks); loss rel err "
            f"{rel:.3g}, grad scaled err {gerr:.3g}; wall {run['wall']:.3f}s"
            f"; device peak above held {run['peak']:,} B; launches "
            f"{run['launches']}; T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s")

    with routing or contextlib.nullcontext():
        auto = call("fused")
        gates("fused autotuned", auto, auto["tune"].slots)
        _add_launches(state, f"{key}-fused", auto["launches"])
        summary = {"auto": {k: auto[k] for k in ("wall", "peak", "launches")},
                   "auto_tune": (auto["tune"].interval, auto["tune"].t_a,
                                 auto["tune"].t_t)}
        del auto
        # a second call: the schedule cached, no probe (the phase's second
        # compiled call is its yardstick)
        warm = call("fused")
        gates("fused autotuned, second call", warm, warm["tune"].slots)
        summary["warm_wall"] = warm["wall"]
        del warm
        torch.cuda.empty_cache()
        interval, slots = pinned
        fused = call("fused", interval=interval, slots=slots)
        gates(f"fused I={interval} s={slots}", fused, slots)
        _add_launches(state, f"{key}-fused-pinned", fused["launches"])
        if release_ref:
            ref_grads.clear()
            _host_empty_cache()
        if plain_gate:
            paths = [pytree.keystr(k) for k, _ in
                     pytree.tree_flatten_with_path(params)[0]]
            summary["plain"] = fused_against_plain(key, model.cfg, call, fused,
                                                   interval, slots, paths)
        fused.pop("grads")
        torch.cuda.empty_cache()
        comp = call("compiled", interval=interval, slots=slots)
        comp.pop("grads")
        carry = _carry_bytes(model, params, batch)
        require(torch.equal(fused["loss"], comp["loss"]),
                f"{key}: the fused loss {float(fused['loss'])!r} is not bit for "
                f"bit the compiled one's {float(comp['loss'])!r}")
        require(fused["plan"].plan_id == comp["plan"].plan_id,
                f"{key}: plans differ ({fused['plan'].plan_id}, "
                f"{comp['plan'].plan_id})")
        require(fused["peak"] <= comp["peak"] + 2 * carry,
                f"{key}: the fused peak {fused['peak']:,} B is more than two "
                f"carries ({carry:,} B each) above the compiled "
                f"{comp['peak']:,} B")
        comp_want = {k: per_step[k] * comp["stats"].advances for k in kernels}
        comp_want.update(layer_launches(
            layer, comp["stats"].advances,
            sum(seg.length for seg in comp["plan"].segments)))
        comp_got = {k: comp["launches"][k] for k in comp_want}
        require(comp_got == comp_want,
                f"{key}: compiled launches {comp_got}, expected {comp_want}")
        fused_got = {k: fused["launches"][k] for k in comp_want}
        log(f"[{key}] compiled I={interval} s={slots}: loss bit for bit the "
            f"fused one's, same plan; wall {comp['wall']:.3f}s (fused "
            f"{fused['wall']:.3f}s); device peak above held {comp['peak']:,} B "
            f"(fused {fused['peak']:,} B, carry {carry:,} B); model-kernel "
            f"launches {comp_got} (fused {fused_got}: phase A leaves out each "
            "segment's last chunk, the checkpointed vjp runs it twice)")
        summary.update(pinned=(interval, slots), carry=carry,
                       fused={k: fused[k] for k in ("wall", "peak", "launches")},
                       compiled={k: comp[k] for k in ("wall", "peak")})
        del fused, comp
        torch.cuda.empty_cache()
        summary["advance_ms"] = time_generic_advance(torch, model, params,
                                                     batch, interval, slots)
        log(f"[{key}] one advance of the first {interval} chain steps (chunk "
            f"layout at s={slots}), device ms (CUDA events): fused "
            f"{summary['advance_ms']['fused']:.3f}, compiled "
            f"{summary['advance_ms']['compiled']:.3f}")
        state[f"{key}-fused"] = summary


def time_generic_advance(torch, model, params, batch, interval, slots):
    """Device ms of one fused advance of the chain's first ``interval``
    steps (``segment_generic.advance``: the steps plus an ``entry_store``
    a chunk on the side stream, waited for at the end) against the
    compiled runner's advance of them (the steps alone), in turns; the
    better of two timings each."""
    from torch.utils import _pytree as pytree

    from repro_torch.core.compiled_ops import CompiledChainOps
    from repro_torch.core.schedule import chunk_length
    from repro_torch.kernels import segment_generic as sg

    spec = model.train_loss.chain_spec
    with torch.no_grad():
        carry0, xs = spec.prelude(params, batch)
    xs_seg = pytree.tree_map(lambda t: t[:interval], xs)
    chunk = chunk_length(interval, slots) or interval
    ops = CompiledChainOps(spec.body, None, ())
    cur = torch.cuda.current_stream()

    def fused():
        cur.wait_event(sg.advance(spec.body, params, carry0, xs_seg, batch,
                                  chunk=chunk).ready)

    def compiled():
        ops.advance_segment(params, carry0, xs_seg, batch)

    times = {"fused": [], "compiled": []}
    for name in ("compiled", "fused", "fused", "compiled"):
        times[name].append(cuda_ms(fused if name == "fused" else compiled,
                                   2))
    return {k: min(v) for k, v in times.items()}


def _experts_on_host(params):
    """``params`` with its expert leaves (what ``offload_params=
    "moe_experts"`` streams) copied to host memory."""
    from torch.utils import _pytree as pytree

    from repro_torch.api.frontend import _expert_leaf_ids

    leaves, spec = pytree.tree_flatten(params)
    ids = set(_expert_leaf_ids(params))
    return pytree.tree_unflatten(
        [t.cpu() if i in ids else t for i, t in enumerate(leaves)],
        spec), sum(leaves[i].numel() * leaves[i].element_size()
                   for i in ids)


def _host_empty_cache() -> None:
    """Return the page-locked host allocator's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch._C._host_emptyCache()


def host_memory_line() -> str:
    """This process's resident set, the host's MemAvailable and the
    page-locked host allocator's current bytes."""
    import torch

    stats = torch.cuda.host_memory_stats()
    return (f"VmRSS {vm_rss():,} B, MemAvailable "
            f"{host_meminfo()['MemAvailable']:,} B, page-locked allocated "
            f"{stats.get('allocated_bytes.current', -1):,} B")


def decoder_stream(state, key, model, params, batch, vg, plan, kernels,
                   per_step, layer=None) -> None:
    """One ``offload_params="moe_experts"`` gradient at the schedule of the
    unstreamed transform ``vg`` (cached), the expert weights on the host:
    its loss and every gradient leaf ``torch.equal`` to one more unstreamed
    call's (kept on the host meanwhile), one parameter batch a segment and
    phase, each blob read once a phase; ``kernels`` launched ``per_step`` a
    step advanced, the ``layer`` kernels as :func:`layer_launches` says."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api

    log(f"[{key}] host memory before the streamed check: "
        f"{host_memory_line()}")
    u_loss, u_grads = vg(params, batch)
    tune = api.last_tune()
    require(api.last_plan().plan_id == plan.plan_id,
            f"{key}: the unstreamed call changed plan")
    u_loss = u_loss.cpu()
    u_grads = [g.cpu() for g in pytree.tree_leaves(u_grads)]
    host_params, expert_bytes = _experts_on_host(params)
    s_vg = api.value_and_grad_offloaded(
        model.train_loss, interval=tune.interval, slots=tune.slots,
        offload_params="moe_experts", device="cuda")
    layer = layer or {}
    counted = {**kernels, **{k: v[0] for k, v in layer.items()}}
    zero_launches(counted.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s_loss, s_grads = s_vg(host_params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in counted.items()}
    stats, s_plan = api.last_stats(), api.last_plan()
    require(s_plan.plan_id == plan.plan_id,
            f"{key} streamed: plan {s_plan.plan_id}, unstreamed "
            f"{plan.plan_id}")
    s_leaves = pytree.tree_leaves(s_grads)
    require(len(s_leaves) == len(u_grads)
            and torch.equal(s_loss.cpu(), u_loss)
            and all(torch.equal(a, b.to(a.device))
                    for a, b in zip(s_leaves, u_grads)),
            f"{key} streamed: loss or gradients not bit for bit the "
            "unstreamed call's")
    want_batches = 2 * plan.num_segments
    require(stats.param_prefetches == want_batches
            and stats.param_bytes_moved == 2 * expert_bytes,
            f"{key} streamed: {stats.param_prefetches} parameter batches "
            f"({want_batches} planned), {stats.param_bytes_moved} B moved "
            f"({2 * expert_bytes} planned: every blob once a phase)")
    want = {name: per_step[name] * stats.advances for name in kernels}
    want.update(layer_launches(layer, stats.advances,
                               sum(seg.length for seg in s_plan.segments)))
    require(launches == want and all(want.values()),
            f"{key} streamed: launched {launches}, expected {want}")
    log(f"[{key}] streamed (offload_params='moe_experts', I="
        f"{tune.interval}, the experts' {expert_bytes:,} B on the host): "
        f"loss and every gradient leaf bit for bit the unstreamed call's; "
        f"wall {wall:.3f}s; param_prefetches={stats.param_prefetches} "
        f"param_bytes_moved={stats.param_bytes_moved} "
        f"param_fetch_stalls={stats.param_fetch_stalls} (waits "
        f"{stats.param_stall_s:.3f}s); blobs written to Level 2 in "
        f"{stats.param_populate_s:.3f}s; "
        f"l1_peak_device_bytes={peak} (the unstreamed parameters stay on "
        f"the card beside it); launches {launches}")
    _add_launches(state, f"{key}-stream", launches)
    state[f"{key}-stream"] = {"wall_s": wall, "peak": peak,
                              "stalls": stats.param_fetch_stalls,
                              "moved": stats.param_bytes_moved}
    del s_loss, s_grads, s_leaves, host_params, u_grads
    torch.cuda.empty_cache()
    log(f"[{key}] host memory after the streamed check: "
        f"{host_memory_line()}")

class _ReverseSweepPeak:
    """Inside ``with``: where a call's device peak falls.  ``before``: the
    peak before the chain's reverse sweep (``frontend._bwd``, where the
    inner plan recomputes and differentiates a step's layers), the forward
    and the loss head's backward; ``sweep``: the sweep's own peak; the
    peak statistic is reset at the sweep's start and end, so after the
    call ``max_memory_allocated()`` is the peak after the sweep (the
    prelude's backward).  All three absolute."""

    def __enter__(self):
        import torch

        from repro_torch.api import frontend

        self._bwd = bwd = frontend._bwd
        self.before, self.sweep = 0, 0

        def measured(*args):
            torch.cuda.synchronize()
            self.before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = bwd(*args)
            torch.cuda.synchronize()
            self.sweep = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            return out

        frontend._bwd = measured
        return self

    def __exit__(self, *exc):
        from repro_torch.api import frontend

        frontend._bwd = self._bwd


def decoder_2d(state, key, model, params, batch, ref_loss, ref_grads,
               kernels, per_step, tune) -> None:
    """2D plans of a decoder at the first call's schedule (``tune``), under
    the phase's gates.  The byte profile first: it runs on meta tensors and
    must leave the card's allocated bytes and peak where they were.  Then
    three gradients, each measured the same way (the device peak above
    what the call found allocated, the wall): 1D, ``plan_2d=(2, 1)`` and
    ``step_memory_budget=`` the profile's ``sum(layer_bytes) + head_bytes -
    1``.  A 2D call's ``inner_*`` counters must equal the perfmodel's, and
    each kernel runs ``per_step`` launches a step advanced plus the inner
    recompute's (one more forward of every layer a step reversed).  The
    ``(2, 1)`` call must peak below the 1D call; each call's peak is also
    logged by part (:class:`_ReverseSweepPeak`): before the reverse sweep,
    in it, after it."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.analysis.byte_profile import chain_step_byte_profile
    from repro_torch.api.chain import index_xs
    from repro_torch.core import perfmodel as pm

    spec = model.train_loss.chain_spec
    with torch.no_grad():
        carry0, xs = spec.prelude(params, batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sb, lb, hb = chain_step_byte_profile(spec, params, carry0,
                                         index_xs(xs, 0), batch)
    prof_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    require(torch.cuda.max_memory_allocated() == held
            and torch.cuda.memory_allocated() == held,
            f"{key} 2D: the byte profile allocated device memory (peak "
            f"{torch.cuda.max_memory_allocated() - held} B above {held})")
    del carry0, xs
    budget = int(sum(lb) + hb) - 1
    log(f"[{key}] 2D: byte profile in {prof_s:.3f}s on meta tensors, no "
        f"device memory: state {sb} B, layers {[int(b) for b in lb]} B, "
        f"head {int(hb)} B; budget {budget} B")
    runs = {}
    rev = _ReverseSweepPeak()
    for label, kw in (("1D", {}), ("plan_2d=(2, 1)", {"plan_2d": (2, 1)}),
                      ("budget", {"step_memory_budget": budget})):
        vg = api.value_and_grad_offloaded(
            model.train_loss, interval=tune.interval, slots=tune.slots,
            device="cuda", **kw)
        zero_launches(kernels.values())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with rev:
            loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = torch.cuda.max_memory_allocated()
        parts = (rev.before - base, rev.sweep - base, after - base)
        peak = max(parts)
        launches = {k: fn.launches for k, fn in kernels.items()}
        stats, plan = api.last_stats(), api.last_plan()
        grads = pytree.tree_leaves(grads)
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        require(math.isfinite(float(loss))
                and all(bool(g.isfinite().all()) for g in grads),
                f"{key} {label}: non-finite loss or gradients")
        gerr = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
        del grads, loss
        require(rel <= 1e-5, f"{key} {label}: loss rel err {rel} > 1e-5")
        require(gerr <= 1e-3,
                f"{key} {label}: gradient scaled err {gerr} > 1e-3")
        inner = plan.inner
        note = ""
        if kw:
            require(inner is not None and plan.plan_id.endswith(
                f":L={inner.layer_chunks}:H={inner.head_chunks}"),
                f"{key} {label}: plan {plan.plan_id} is not 2D")
            want = (inner.layer_chunks, inner.head_chunks, inner.n_layers,
                    pm.inner_recomputed_layers_model(stats.n, inner),
                    int(pm.inner_boundary_bytes_model(inner, sb)))
            got = (stats.inner_layer_chunks, stats.inner_head_chunks,
                   stats.inner_layers, stats.inner_recomputed_layers,
                   stats.inner_peak_bytes)
            require(got == want and stats.inner_recompute_factor == 1.0,
                    f"{key} {label}: inner counters {got}, perfmodel "
                    f"{want}, recompute factor "
                    f"{stats.inner_recompute_factor}")
            note = (f"; (layer_chunks, head_chunks) = ({inner.layer_chunks}"
                    f", {inner.head_chunks}), boundaries {inner.boundaries}"
                    f"; inner_peak_bytes {stats.inner_peak_bytes}, "
                    "inner_peak_bytes_model "
                    f"{int(pm.inner_peak_bytes_model(inner, lb, sb))} B")
        redo = stats.inner_recomputed_layers // max(1, stats.inner_layers)
        for name, n in launches.items():
            want_n = per_step[name] * (stats.advances + redo)
            require(n == want_n and n > 0,
                    f"{key} {label}: {name} launched {n} times, expected "
                    f"{want_n} ({per_step[name]} x ({stats.advances} "
                    f"advances + {redo} steps recomputed by the inner "
                    "plan))")
        runs[label] = {"peak": peak, "inner": inner}
        _add_launches(state, f"{key} {label}", launches)
        log(f"[{key}] {label}: plan {plan.plan_id}; loss rel err "
            f"{rel:.3g}, grad scaled err {gerr:.3g}; wall {wall:.3f}s; "
            f"device peak {peak:,} B above {base:,} B held (before the "
            f"reverse sweep {parts[0]:,} B, in it {parts[1]:,} B, after it "
            f"{parts[2]:,} B){note}; launches {launches}")
        del vg
    one_d = runs["1D"]["peak"]
    require(runs["plan_2d=(2, 1)"]["peak"] < one_d,
            f"{key}: the plan_2d=(2, 1) call's device peak "
            f"{runs['plan_2d=(2, 1)']['peak']:,} B is not below the 1D "
            f"call's {one_d:,} B")
    hc = runs["budget"]["inner"].head_chunks
    S = batch["tokens"].shape[1] - 1
    if 1 < hc < S / model.cfg.ce_chunk:
        log(f"[{key}] budget plan: head_chunks={hc} widens the CE chunk to "
            f"{-(-S // hc)} rows past ce_chunk={model.cfg.ce_chunk}; its "
            f"peak {runs['budget']['peak']:,} B is "
            f"{'above' if runs['budget']['peak'] > one_d else 'not above'}"
            f" the 1D call's {one_d:,} B")
    else:
        log(f"[{key}] budget plan: head_chunks={hc}, not in (1, "
            f"{S // model.cfg.ce_chunk}): the CE chunk is ce_chunk's")


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
    zero_launches(kernels.values())
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
    zero_launches(kernels.values())
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


# the pinned runner="fused" schedules of phases dense, ssm and moe, (I,
# slots): gemma2-2b's 13 chain steps in one segment, forward chunks 4, 4, 5
# and reverse chunks 4, 4, 4, 1; mamba2-370m's 48 in segments 14, 14, 14,
# 6; phi3.5-moe's 4 in two segments of one chunk of 2, each recomputed in
# its reverse
FUSED_PINNED = {"dense": (13, 4), "ssm": (14, 4), "moe": (2, 2)}


def tied_table_check(torch) -> None:
    """gemma2-2b's tied table read by its embedding and its loss head
    (``layers.embed(tied=True)``, ``head_table``): the table's gradient bit
    for bit the one autograd's sum of the two dense gradients gives.  Two
    device peaks of each way: the whole backward's (the head's chunks set
    it) and that from the gather's cotangent on (a hook on the rows), above
    what was allocated there (one dense gradient of the table against
    two)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("gemma2-2b")
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        device="cuda") * cfg.d_model ** -0.5
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (2, 4097)),
                          dtype=torch.int32, device="cuda")
    grads, peaks = [], []
    for tied in (False, True):
        w = table.clone().requires_grad_(True)
        rows = L.embed({"emb": w}, tokens[:, :-1], tied=tied)
        mark = {}

        def at_gather(g, mark=mark):
            torch.cuda.synchronize()
            mark["whole"] = torch.cuda.max_memory_allocated()
            mark["base"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        rows.register_hook(at_gather)
        loss = L.chunked_ce_loss(rows * 3.0, w, tokens[:, 1:],
                                 chunk=cfg.ce_chunk,
                                 logit_cap=cfg.logit_softcap)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads.append(torch.autograd.grad(loss, [w])[0])
        torch.cuda.synchronize()
        peaks.append((max(mark["whole"], torch.cuda.max_memory_allocated())
                      - base,
                      torch.cuda.max_memory_allocated() - mark["base"]))
        del w, rows, loss
    require(torch.equal(grads[0], grads[1]),
            "the tied table's gradient differs from autograd's sum of the "
            "embedding's and the head's: max |diff| "
            f"{(grads[0] - grads[1]).abs().max().item()}")
    log(f"[dense] tied table ({cfg.vocab}, {cfg.d_model}) fp32: gradient bit "
        f"for bit autograd's sum; device peak of the backward {peaks[1][0]:,}"
        f" B, from the gather's cotangent on {peaks[1][1]:,} B (autograd's "
        f"two dense gradients: {peaks[0][0]:,} B, {peaks[0][1]:,} B)")
    del grads, table
    torch.cuda.empty_cache()


def phase_dense(state) -> None:
    import torch

    from repro_torch.kernels import flash_attention as fa

    tied_table_check(torch)
    # every layer of gemma2-2b's (local, global) period is attention
    decoder_phase(state, "dense", "gemma2-2b", 2,
                  {"flash_attention": fa.flash_attention},
                  {"flash_attention": 2}, revolve_slots=4, tiered_states=4,
                  scan=True, plans_2d=True, fused=FUSED_PINNED["dense"],
                  fused_plain=True)


def phase_ssm(state) -> None:
    from repro_torch.kernels import ssd_scan as ssd

    decoder_phase(state, "ssm", "mamba2-370m", 4, {"ssd_scan": ssd.ssd_scan},
                  {"ssd_scan": 1}, fused=FUSED_PINNED["ssm"],
                  fused_plain=True)


# phi3.5-moe-42b's depth in phase moe: its fp32 parameters are 1.30 B a
# layer (5.2 GB), and dense autograd holds them, their gradients and every
# layer's activations (with the bf16 copies of the expert weights it saves)
MOE_LAYERS = 4
# host memory kept free beside the deep streamed run's two copies of the
# expert weights (the caller's and Level 2's) and one step's transient
MOE_HOST_MARGIN = 16 * 2 ** 30


def moe_depth(state, expert_layer_bytes: int, layer_bytes: int) -> int:
    """The deepest phi3.5-moe the streamed call fits, above
    ``MOE_LAYERS``: on the host, the caller's expert weights and Level 2's
    copy of them (``2 * L * expert_layer_bytes``) plus one step's transient
    (the tuner's read probe) under the host memory available, less
    ``MOE_HOST_MARGIN``; on the card, the 4-layer streamed call's peak
    without the 4 layers' expert weights (which the deep run keeps on the
    host), plus each further layer's expert gradient and non-expert weights
    and gradient, under 90% of the card's memory.

    The host memory available is MemAvailable as phase ``device`` read it,
    less what this process has grown by since (its resident set).  The
    sandbox the card's machine runs in keeps memory a process freed out of
    MemAvailable for a while (it returns to the process that freed it, not
    to the count), so MemAvailable read now undercounts what the run can
    use."""
    import torch

    _host_empty_cache()
    now = host_meminfo()["MemAvailable"]
    seen = state.get("host_mem") or {"avail": now, "rss": vm_rss()}
    avail = seen["avail"] - max(0, vm_rss() - seen["rss"])
    log(f"[moe] host memory before sizing the deep run: "
        f"{host_memory_line()}; available by phase device's reading less "
        f"this process's growth since: {avail:,} B")
    by_host = (avail - MOE_HOST_MARGIN - expert_layer_bytes) // \
        (2 * expert_layer_bytes)
    card = torch.cuda.get_device_properties(0).total_memory
    base = state["moe-stream"]["peak"] - MOE_LAYERS * expert_layer_bytes
    per_layer = expert_layer_bytes + 2 * (layer_bytes - expert_layer_bytes)
    by_card = MOE_LAYERS + int((0.9 * card - base) // per_layer)
    depth = int(min(by_host, by_card))
    log(f"[moe] depth: host memory available {avail:,} B allows {by_host} "
        f"layers (2 x {expert_layer_bytes:,} B a layer + one layer's "
        f"transient, {MOE_HOST_MARGIN:,} B kept free); the card "
        f"({card:,} B) {by_card} (the 4-layer streamed peak less its "
        f"experts, {base:,} B, + {per_layer:,} B a layer, under 90%); "
        f"chosen {depth}")
    return depth


def _unstreamed_call(model, params, batch):
    """One unstreamed offloaded gradient at I=1, s=1 (the least device
    memory it takes): ``(None, its device peak)``, or ``(the
    OutOfMemoryError's first line, None)``."""
    import gc

    import torch

    from repro_torch import api

    vg = api.value_and_grad_offloaded(model.train_loss, interval=1, slots=1,
                                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oom = peak = None
    try:
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del loss, grads
    except torch.cuda.OutOfMemoryError as err:
        oom = str(err).splitlines()[0]
    del vg
    gc.collect()
    torch.cuda.empty_cache()
    return oom, peak


def moe_deep(state) -> None:
    """phi3.5-moe at the deepest depth streaming allows (``moe_depth``),
    the expert weights on the host: the unstreamed call must run out of
    device memory there -- or, where the card holds it, one layer deeper
    (the experts on the card), and the streamed call must peak below it --
    the streamed one must run, its loss within 1e-5 (relative) of a
    ``no_grad`` forward that moves one layer's weights to the card at a
    time, every gradient finite."""
    import gc

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.api.frontend import _expert_leaf_ids
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model_factory import get_model

    cfg1 = get_config("phi3.5-moe-42b")
    # w_gate, w_up (d x f) and w_down (f x d) of every expert, fp32
    expert_layer_bytes = 3 * cfg1.moe.n_experts * cfg1.d_model * cfg1.d_ff * 4
    layer_bytes = state["moe"]["layer_param_bytes"]
    depth = moe_depth(state, expert_layer_bytes, layer_bytes)
    require(depth > MOE_LAYERS, f"moe: streaming allows {depth} layers, "
            f"not more than {MOE_LAYERS}")
    cfg = cfg1.replace(n_layers=depth)
    full = SHAPES["train_4k"]
    shape = ShapeSpec(full.name, full.seq_len, 2, full.kind)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    params, expert_bytes = _experts_on_host(params)
    torch.cuda.empty_cache()
    log(f"[moe] deep: host memory with the experts on the host: "
        f"{host_memory_line()}")
    batch = make_batch(cfg, shape, seed=0)
    held = torch.cuda.memory_allocated()
    log(f"[moe] deep: {depth} layers, the experts' {expert_bytes:,} B on the "
        f"host, {held:,} B of parameters and tokens on the card")

    # without streaming: the card cannot hold it, or, where it can (the
    # program grew leaner than this depth's margin), it cannot one layer
    # deeper, and the streamed call below must peak lower
    oom, unstreamed_peak = _unstreamed_call(model, params, batch)
    if oom is None:
        log(f"[moe] deep, unstreamed: {depth} layers fit the card "
            f"(device peak {unstreamed_peak:,} B); the host streams no "
            f"deeper, so the card's limit is shown one layer deeper, the "
            "experts on the card")
        deeper = get_model(cfg.replace(n_layers=depth + 1))
        with torch.no_grad():
            deep_params = deeper.init(
                torch.Generator(device="cuda").manual_seed(1), device="cuda")
        oom, _ = _unstreamed_call(deeper, deep_params, batch)
        del deeper, deep_params
        gc.collect()
        torch.cuda.empty_cache()
        require(oom is not None, f"moe: the unstreamed call at {depth + 1} "
                "layers did not run out of device memory")
        log(f"[moe] deep, unstreamed at {depth + 1} layers: "
            f"torch.cuda.OutOfMemoryError ({oom[:160]})")
    else:
        log(f"[moe] deep, unstreamed: torch.cuda.OutOfMemoryError "
            f"({oom[:160]}); after emptying the cache "
            f"{torch.cuda.memory_allocated():,} B allocated")

    vg = api.value_and_grad_offloaded(model.train_loss,
                                      offload_params="moe_experts",
                                      device="cuda")
    layer = layer_kernels(cfg)
    counted = {"flash_attention": fa.flash_attention,
               **{k: v[0] for k, v in layer.items()}}
    zero_launches(counted.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in counted.items()}
    tune, stats, plan = api.last_tune(), api.last_stats(), api.last_plan()
    leaves = pytree.tree_leaves(grads)
    require(math.isfinite(float(loss))
            and all(bool(g.isfinite().all()) for g in leaves),
            "moe deep: non-finite loss or gradients")
    require(stats.param_prefetches == 2 * plan.num_segments
            and stats.param_bytes_moved == 2 * expert_bytes,
            f"moe deep: {stats.param_prefetches} parameter batches, "
            f"{stats.param_bytes_moved} B moved; the plan implies "
            f"{2 * plan.num_segments} and {2 * expert_bytes}")
    probe = tune.probe_calls * tune.probe_len
    want = {"flash_attention": stats.advances + probe}
    want.update(layer_launches(layer, stats.advances + probe,
                               sum(seg.length for seg in plan.segments)))
    require(launches == want and all(want.values()),
            f"moe deep: launched {launches}, the plan implies {want}")
    on_card = sum(1 for i in _expert_leaf_ids(params) if leaves[i].is_cuda)
    del grads, leaves
    # the reference: one layer's weights on the card at a time
    spec = model.train_loss.chain_spec
    with torch.no_grad():
        carry, xs = spec.prelude(params, batch)
        for k in range(cfg.n_layers):
            x = pytree.tree_map(lambda t: t[k].to("cuda"), xs)
            carry = spec.body(params, carry, x, batch)
            del x
        ref = spec.readout(params, carry, batch)
    del carry, xs
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    require(rel <= 1e-5, f"moe deep: loss rel err {rel} > 1e-5 against the "
            "layer-at-a-time forward")
    require(unstreamed_peak is None or peak < unstreamed_peak,
            f"moe deep: the streamed call peaked at {peak:,} B, the "
            f"unstreamed one at {unstreamed_peak:,} B")
    log(f"[moe] deep: host memory after the streamed call: "
        f"{host_memory_line()}")
    log(f"[moe] deep, streamed: tune I={tune.interval} s={tune.slots} "
        f"T_A={tune.t_a:.6e}s T_T={tune.t_t:.6e}s T_T_param="
        f"{tune.t_t_param:.6e}s ({tune.source}); {plan.num_segments} "
        f"segments; loss {float(loss):.6f} (rel err {rel:.3g} against the "
        f"layer-at-a-time forward); every gradient finite (the {on_card} "
        f"expert leaves' on the card); wall {wall:.3f}s; "
        f"l1_peak_device_bytes={peak}; param_prefetches="
        f"{stats.param_prefetches} param_bytes_moved="
        f"{stats.param_bytes_moved} param_fetch_stalls="
        f"{stats.param_fetch_stalls} (waits {stats.param_stall_s:.3f}s); "
        f"blobs written to Level 2 in {stats.param_populate_s:.3f}s; "
        f"launches {launches}")
    _add_launches(state, "moe-deep", launches)
    state["moe-deep"] = {"layers": depth, "wall_s": wall, "peak": peak,
                         "oom": oom, "loss_rel": rel,
                         "unstreamed_peak": unstreamed_peak}
    del params, vg, loss
    gc.collect()
    torch.cuda.empty_cache()
    _host_empty_cache()


def phase_moe(state) -> None:
    from repro_torch.kernels import flash_attention as fa

    # one attn_moe layer a period: one flash launch a chain step; the MoE
    # layer's kernels (routing, slots, dispatch, experts, combine) and the
    # rest of the body's counted in every call
    decoder_phase(state, "moe", "phi3.5-moe-42b", 2,
                  {"flash_attention": fa.flash_attention},
                  {"flash_attention": 1}, n_layers=MOE_LAYERS, stream=True,
                  fused=FUSED_PINNED["moe"], fused_plain=True,
                  layer_gates=True)
    moe_deep(state)


FAMILY_BATCH = 2   # train_4k's global batch of 256, cut


def family_call(torch, model, params, batch, kernels, plain=False):
    """Dense autograd of ``train_loss``: ``(loss, grads, wall, peak above
    what it found allocated, launches)``; ``plain`` inside
    :class:`_PlainVersions`."""
    zero_launches(kernels.values(), plain)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = _tree_value_and_grad(torch, model.train_loss, params,
                                       batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (loss, grads, wall, torch.cuda.max_memory_allocated() - base,
            {k: fn.launches for k, fn in kernels.items()})


def phase_families(state) -> None:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.core import offload as ofl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models.model_factory import get_model

    sf.clear_caches()
    ofl.clear_pools()
    full = SHAPES["train_4k"]
    shape = ShapeSpec(full.name, full.seq_len, FAMILY_BATCH, full.kind)
    kernels = {"flash_attention": fa.flash_attention,
               **{k: v[0] for k, v in layer_kernels(
                   get_config("internvl2-1b")).items()}}
    for arch in ("internvl2-1b", "whisper-tiny"):
        cfg = get_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        batch = make_batch(cfg, shape, seed=0)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        inputs = {k: tuple(v.shape) for k, v in batch.items()}
        # the first call pays for the allocator's growth and library set-up
        first = family_call(torch, model, params, batch, kernels)
        del first
        loss, grads, wall, peak, launches = family_call(
            torch, model, params, batch, kernels)
        require(math.isfinite(float(loss))
                and all(bool(g.isfinite().all()) for g in grads),
                f"families {arch}: non-finite loss or gradients")
        line = (f"[families] {arch}: {n_params:,} parameters, inputs "
                f"{inputs}; loss {float(loss):.6f}; dense autograd wall "
                f"{wall:.3f}s, device peak {peak:,} B above what it held; "
                f"launches {launches}")
        if cfg.family == "vlm":
            want = cfg.n_layers
            require(launches["flash_attention"] == want,
                    f"families {arch}: flash_attention launched "
                    f"{launches['flash_attention']} times in one forward, "
                    f"expected {want} (one a layer)")
            with _PlainVersions():
                p_loss, p_grads, p_wall, p_peak, p_launches = family_call(
                    torch, model, params, batch, kernels, plain=True)
            require(not any(p_launches.values()),
                    f"families {arch}: the plain versions launched "
                    f"{p_launches}")
            # the referee: fp32 compute through the plain versions.  Both
            # bf16 gradients are a bf16 rounding of it, 24 layers deep;
            # the kernels may add at most the bf16 gate to what the plain
            # versions' rounding already costs, leaf by leaf
            from repro_torch.models import transformer as tfm
            from repro_torch.models.layers import DTypes

            dts = tfm._dtypes
            tfm._dtypes = lambda c: DTypes(compute=torch.float32)
            try:
                with _PlainVersions():
                    r_loss, r_grads, *_ = family_call(torch, model, params,
                                                      batch, kernels,
                                                      plain=True)
            finally:
                tfm._dtypes = dts
            paths = [pytree.keystr(k) for k, _ in
                     pytree.tree_flatten_with_path(params)[0]]
            rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
            gerr = max((scaled_err(a, b), pth)
                       for a, b, pth in zip(grads, p_grads, paths))
            worst = max((scaled_err(a, r) - scaled_err(b, r), pth)
                        for a, b, r, pth in zip(grads, p_grads, r_grads,
                                                paths))
            for name, gg in (("kernels", grads), ("plain", p_grads)):
                e32 = sorted(((scaled_err(a, b), pth) for a, b, pth in
                              zip(gg, r_grads, paths)), reverse=True)
                log(f"[families] {arch}: {name} bf16 gradient against the "
                    f"fp32 one (loss {float(r_loss):.6f}), worst leaves "
                    f"{[(pth, round(e, 5)) for e, pth in e32[:3]]}")
            del r_grads
            require(rel <= 3e-2 and worst[0] <= 3e-2,
                    f"families {arch}: the kernels against the plain "
                    f"versions: loss rel err {rel}; at {worst[1]} the "
                    "kernels' gradient's scaled distance from the fp32 one "
                    f"exceeds the plain versions' by {worst[0]} (gate 3e-2)")
            line += (f"; against the plain versions (wall "
                     f"{p_wall:.3f}s, peak {p_peak:,} B): loss rel err "
                     f"{rel:.3g}, grad scaled err {gerr[0]:.3g} "
                     f"({gerr[1]}); the kernels' gradient's distance from "
                     f"the fp32 one less the plain's: at most "
                     f"{worst[0]:.3g} ({worst[1]})")
            del p_grads
            _add_launches(state, "families", launches)
        else:
            require(launches["flash_attention"] == 0,
                    f"families {arch}: the encoder at "
                    f"{batch['frames'].shape[1]} frames takes the dense "
                    "path, but the kernel was launched")
            line += ("; every attention is at most 2,048 long: the dense "
                     "path, no kernel")
        log(line)
        del params, grads, loss
        torch.cuda.empty_cache()


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
            ptr(bh), ptr(bc), ptr(nxt[0]), ptr(nxt[1]), None, 0, 0, stream)
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


def _time_entry_store(torch, arch):
    """``entry_store`` at a decoder's carry into page-locked slots (the
    side stream, waited for on the timed stream), its plain version
    (``copy_``, which waits for its copy) and the copy engine
    (``copy_(non_blocking=True)`` into the same slots).  Bound: the bytes
    over the host link, the slower of the two rates they cross."""
    from repro_torch.core.offload import _slot
    from repro_torch.kernels import segment_generic as sg

    leaves = generic_carry(torch, arch, 70)
    dsts = [_slot(t, pin=True) for t in leaves]
    cur = torch.cuda.current_stream()
    n0 = sg.entry_store.launches
    ms_k = cuda_ms(lambda: cur.wait_event(sg.entry_store(leaves, dsts)), 20)
    sg.entry_store.launches = n0   # timing launches are not the path's
    ms_p = cuda_ms(lambda: sg.entry_store_plain(leaves, dsts), 20)

    def engine():
        for s, d in zip(leaves, dsts):
            d.copy_(s, non_blocking=True)

    ms_l = cuda_ms(engine, 20)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    b_ms = nbytes / PCIE_BYTES_PER_S * 1e3
    log(f"[timing] entry_store at {arch}'s carry ({nbytes:,} B): {ms_k:.4f} "
        f"ms ({nbytes / ms_k / 1e6:.2f} GB/s), plain {ms_p:.4f} ms, copy "
        f"engine {ms_l:.4f} ms ({nbytes / ms_l / 1e6:.2f} GB/s); bound "
        f"{b_ms:.4f} ms at 64 GB/s")
    return ms_k, ms_p, b_ms, ms_l


def _time_fold(torch, case, label):
    """``fold`` on one case's chunk (its first cotangent and its rows)
    beside its plain version and ``torch._foreach_add_`` plus
    ``torch._foreach_copy_`` over the same lists.  Bound: the bytes read
    and written over the card's memory rate."""
    from repro_torch.kernels import segment_generic as sg

    gacc, dps, full, rows, src_rows = case(torch)
    dps, dst_rows = dps[:1], rows(full)
    acc, ops = sg.fold_plan(gacc, dps, dst_rows, src_rows)
    gacc = {k: a for k, a in zip(gacc, acc)}   # every read leaf a buffer
    acc, ops = sg.fold_plan(gacc, dps, dst_rows, src_rows)
    n0 = sg.fold.launches
    ms_k = cuda_ms(lambda: sg.fold(gacc, dps, dst_rows, src_rows), 10)
    sg.fold.launches = n0   # timing launches are not the path's
    ms_p = cuda_ms(lambda: sg.fold_plain(ops), 10)
    adds = [(d, srcs[0]) for d, srcs, kind in ops if kind == "add"]
    copies = [(d, srcs[0]) for d, srcs, kind in ops if kind == "copy"]

    def library():
        if adds:
            torch._foreach_add_([d for d, _ in adds], [s for _, s in adds])
        torch._foreach_copy_([d for d, _ in copies],
                             [s for _, s in copies])

    ms_l = cuda_ms(library, 10)
    nbytes = sum((3 if kind == "add" else 2) * srcs[0].numel()
                 * srcs[0].element_size() for _, srcs, kind in ops)
    b_ms, by = bound_ms(nbytes, 0.0)
    log(f"[timing] fold at {label} ({len(adds)} adds, {len(copies)} row "
        f"copies, {nbytes:,} B read and written): {ms_k:.4f} ms "
        f"({nbytes / ms_k / 1e9:.3f} TB/s), plain {ms_p:.4f} ms, "
        f"_foreach_add_ + _foreach_copy_ {ms_l:.4f} ms; bound {b_ms:.4f} ms "
        "at 3.35 TB/s")
    del gacc, dps, full, dst_rows, src_rows, ops, adds, copies
    torch.cuda.empty_cache()
    return ms_k, ms_p, b_ms, by, ms_l


def _time_generic(torch):
    """The two kernels of the generic fused segments at the decoders'
    shapes: ``entry_store`` at gemma2-2b's and mamba2-370m's carries (the
    row: gemma2-2b's), ``fold`` at gemma2-2b's main-path chunk (the row:
    row copies only) and at the synthetic case with adds."""
    stores = {arch: _time_entry_store(torch, arch) for arch in CARRIES}
    fold_main = _time_fold(torch, generic_fold_chunk,
                           "gemma2-2b's main-path chunk")
    _time_fold(torch, generic_fold_case,
               "the synthetic add case (not the main path's)")
    src = "src/repro_torch/kernels/csrc/segment_generic.cu"
    k_ms, p_ms, s_ms, l_ms = stores["gemma2-2b"]
    ms_k, ms_p, b_ms, by, ms_l = fold_main
    # the parts of the TPU kernels they stand for: the chunk-entry copy
    # out, and the fold with its dxd rows
    return [("entry_store", src, "src/repro/kernels/segment_pallas.py:205",
             k_ms, p_ms, s_ms, "bytes", l_ms, 0.0),
            ("fold", src, "src/repro/kernels/segment_pallas.py:414", ms_k,
             ms_p, b_ms, by, ms_l, 0.0)]


def _time_flash_bwd(torch, cfg, B, S):
    """The attention backward at a decoder's layer shape (gemma2-2b's: its
    softcap, one layer kind's cost is the other's at S=4096; phi3.5-moe's),
    its plain version, and SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` on K/V repeated per group: no softcap,
    and its dK/dV per query head, not summed per group).  Returns ``(ms,
    plain_ms, bound_ms, by, library_ms, flops)``."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import _chunked_bwd

    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(41)
    bf16 = torch.bfloat16
    q = _randn(torch, rng, (B, S, H, D), bf16)
    k = _randn(torch, rng, (B, S, G, D), bf16)
    v = _randn(torch, rng, (B, S, G, D), bf16)
    dout = _randn(torch, rng, (B, S, H, D), bf16)
    kw = {"softcap": cfg.attn_softcap, "scale": cfg.query_scale}
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ms_k = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  **kw), 5)
    res = (q, k, v, out, lse)
    ms_p = cuda_ms(lambda: _chunked_bwd(True, None, cfg.attn_softcap, 1024,
                                        cfg.query_scale, res, dout), 2)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        scale=cfg.query_scale)
    dot = dout.transpose(1, 2).contiguous()
    ms_l = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True), 5)
    # the five products of the backward (S, dP, dV, dK, dQ) over the
    # causal (query, key) pairs; q, out, dout, dq and k, v, dk, dv once
    # each, lse
    flops = 10.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2.0 * (4 * B * S * H * D + 4 * B * S * G * D) + 4.0 * B * H * S
    b_ms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
    log(f"[timing] flash_attention_bwd at {cfg.name}'s B={B} S={S} H={H} "
        f"G={G} D={D} bf16 (softcap {cfg.attn_softcap}): {ms_k:.4f} ms, "
        f"{flops / ms_k / 1e9:.1f} TFLOP/s of the five products (plain "
        f"{ms_p:.4f} ms; bound {b_ms:.4f} ms by {by}; library {ms_l:.4f} "
        "ms: SDPA's backward on K/V repeated per group"
        + (")" if cfg.attn_softcap is None else ", without the softcap)"))
    del qt, kt, vt, ot
    return ms_k, ms_p, b_ms, by, ms_l, flops


def timing_row(name, source, replaces, k_fn, p_fn, nbytes, flops=0.0,
               l_fn=None, what="", iters=(20, 5)):
    """One bf16 decoder kernel's row of the kernels line: its time, its
    plain version's and the library call's (``l_fn``, if any; ``iters``
    launches of the kernel and the library call, of the plain version),
    and its bound (``nbytes`` at 3.35 TB/s against ``flops`` at the bf16
    peak), logged."""
    ms_k = cuda_ms(k_fn, iters[0])
    ms_p = cuda_ms(p_fn, iters[1])
    ms_l = cuda_ms(l_fn, iters[0]) if l_fn is not None else None
    b_ms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
    log(f"[timing] {name}{what}: {ms_k:.4f} ms "
        f"({nbytes / ms_k / 1e6:.0f} GB/s; plain {ms_p:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by}, library "
        f"{'none' if ms_l is None else f'{ms_l:.4f} ms'})")
    return (name, source, replaces, ms_k, ms_p, b_ms, by, ms_l, flops)


def timing_alt(name, k_fn, nbytes, what, iters=20):
    """A kernel's other form (the one a row's main-path form replaced, or
    a second main-path form), logged beside its row: its time and its
    bound (bytes at 3.35 TB/s)."""
    ms = cuda_ms(k_fn, iters)
    b_ms, by = bound_ms(nbytes, 0.0, BF16_TC_FLOPS)
    log(f"[timing] {name} {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
        f"{by})")
    return ms


def _time_layer_kernels(torch, state):
    """The layer kernels of gemma2-2b's body at the dense phase's shapes
    (B=2, S=4096), each beside its plain version and its bound (bytes at
    3.35 TB/s: every input read once, every output written once), and
    ``F.rms_norm`` on ``1 + scale`` for rmsnorm, its gradient through
    autograd for rmsnorm's backward (no single PyTorch call computes the
    others); the attention backward also at phi3.5-moe's
    layer.  Returns the kernels line's rows."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import glu as glu_mod
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.models.layers import rope_table

    csrc = "src/repro_torch/kernels/csrc/"
    # the TPU kernel whose traced body computed them (the segment kernels'
    # chunk scans and chunk vjp)
    rep = "src/repro/kernels/segment_pallas.py:248"
    rows = []
    gemma = get_config("gemma2-2b")
    fb = _time_flash_bwd(torch, gemma, 2, 4096)
    rows.append(("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
                 rep, *fb))
    if "moe" in state:
        run = state["moe"]
        _time_flash_bwd(torch, run["cfg"], run["B"], run["S"])
    torch.cuda.empty_cache()

    rng = np.random.default_rng(71)
    bf16 = torch.bfloat16
    N, d = GEMMA_ROWS, GEMMA_D
    x = _randn(torch, rng, (2, 4096, d), bf16)
    res = _randn(torch, rng, (2, 4096, d), bf16)
    g = _randn(torch, rng, (2, 4096, d), bf16)
    scale = _randn(torch, rng, (d,), torch.float32, 0.3)

    def row(name, src, k_fn, p_fn, nbytes, l_fn=None, what=""):
        return timing_row(name, csrc + src, rep, k_fn, p_fn, nbytes,
                          l_fn=l_fn, what=what, iters=(20, 5))

    el = 2.0
    w = (1.0 + scale).to(bf16)
    rms_lib = getattr(F, "rms_norm", None)
    rows.append(row(
        "rmsnorm", "rmsnorm.cu",
        lambda: rn.rmsnorm(x, scale, out_dtype=bf16),
        lambda: rn.rmsnorm_fwd_plain(x, scale, None, 1e-6, bf16),
        2 * el * N * d + 4.0 * (N + d),
        None if rms_lib is None else (lambda: rms_lib(x, (d,), w, 1e-6)),
        f" at ({N}, {d}) bf16 (ln1, ln2)"))
    row("rmsnorm", "rmsnorm.cu",
        lambda: rn.rmsnorm(x, scale, res, out_dtype=bf16),
        lambda: rn.rmsnorm_fwd_plain(x, scale, res, 1e-6, bf16),
        3 * el * N * d + 4.0 * (N + d), None,
        " with the residual (the post-norms)")
    _, rstd = rn.rmsnorm(x, scale, out_dtype=bf16)
    # the library's backward: autograd through F.rms_norm, the gradient of
    # its weight (1 + scale) being dscale
    lib_bwd = None
    if rms_lib is not None:
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        yl = rms_lib(xl, (d,), wl, 1e-6)

        def lib_bwd():
            return torch.autograd.grad(yl, (xl, wl), g, retain_graph=True)
    # the main path's form: gemma2-2b's ln1, whose output q, k and v read
    # and whose input the residual passes on (three cotangents summed and
    # the skip's added in the kernel); no one PyTorch call computes it
    g2, g3, dskip = (_randn(torch, rng, (2, 4096, d), bf16)
                     for _ in range(3))
    rows.append(row(
        "rmsnorm_bwd", "rmsnorm.cu",
        lambda: rn.rmsnorm_bwd(g, x, scale, rstd, g_more=(g2, g3),
                               dskip=dskip),
        lambda: (rn.rmsnorm_bwd_plain((g + g2) + g3, x, scale, 1e-6,
                                      bf16)[0] + dskip),
        6 * el * N * d + 4.0 * (N + 2 * d), None,
        f" at ({N}, {d}) bf16, three consumers' cotangents and the skip's "
        "(gemma2-2b's ln1)"))
    timing_alt("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(g, x, scale, rstd),
               3 * el * N * d + 4.0 * (N + 2 * d),
               "with one cotangent (the final norm; the row's form before)")
    timing_alt("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(
        g, x, scale, rstd, g_more=(g2,), dskip=dskip),
        5 * el * N * d + 4.0 * (N + 2 * d),
        "with two consumers' cotangents and the skip's (gemma2-2b's ln2)")
    if lib_bwd is not None:
        timing_alt("F.rms_norm's gradient", lib_bwd,
                   3 * el * N * d + 4.0 * (N + 2 * d),
                   "through autograd (one cotangent: the library yardstick "
                   "of the row's form before)")
    del x, res, g, rstd, lib_bwd, g2, g3, dskip
    n = 2 * 4096 * GEMMA_FF
    gate, up, gg = (_randn(torch, rng, (2, 4096, GEMMA_FF), bf16)
                    for _ in range(3))
    rows.append(row(
        "glu", "glu.cu", lambda: glu_mod.glu(gate, up, "gelu"),
        lambda: glu_mod.glu_plain(gate, up, "gelu"), 3 * el * n, None,
        f" (GeGLU) at (2, 4096, {GEMMA_FF}) bf16"))
    rows.append(row(
        "glu_bwd", "glu.cu", lambda: glu_mod.glu_bwd(gg, gate, up, "gelu"),
        lambda: glu_mod.glu_bwd_plain(gg, gate, up, "gelu"), 5 * el * n,
        None, " (GeGLU)"))
    del gate, up, gg
    cos, sin = rope_table(4096, 256, device="cuda")
    qk = [_randn(torch, rng, sh, bf16) for sh in GEMMA_QK]
    gs = [_randn(torch, rng, sh, bf16) for sh in GEMMA_QK]
    nqk = sum(t.numel() for t in qk)
    theta = get_config("gemma2-2b").rope_theta
    # the main path's form: the angles from theta in the kernel (the plain
    # version builds the table and rotates)
    rows.append(row(
        "rope", "rope.cu",
        lambda: rope_mod.rope(qk, None, None, theta=theta),
        lambda: [rope_mod.rope_plain(t, *rope_table(4096, 256, theta,
                                                    device="cuda"))
                 for t in qk],
        2 * el * nqk, None,
        " (q and k in one launch, the angles from theta) at gemma2-2b's q "
        "(2, 4096, 8, 256), k (2, 4096, 4, 256) bf16"))
    rows.append(row(
        "rope_bwd", "rope.cu",
        lambda: rope_mod.rope_bwd(gs, None, None, theta=theta),
        lambda: [rope_mod.rope_bwd_plain(t, x, cos, sin)
                 for t, x in zip(gs, qk)],
        2 * el * nqk, None, " (the angles from theta)"))
    for name, fn, xs in (("rope", rope_mod.rope, qk),
                         ("rope_bwd", rope_mod.rope_bwd, gs)):
        timing_alt(name, lambda: fn(xs, cos, sin),
                   2 * el * nqk + 2 * 4.0 * cos.numel(),
                   "on the table (the row's form before)")
    timing_alt("rope_table", lambda: rope_table(4096, 256, theta,
                                                device="cuda"),
               2 * 4.0 * cos.numel(), "(the per-layer table it replaces)")
    del qk, gs
    torch.cuda.empty_cache()
    return rows


def _time_dense(torch, state):
    """The projection GEMM at every projection of gemma2-2b's and
    mamba2-370m's layers (``DENSE_CASES``; x, dy bf16, w the fp32
    parameter): the forward, dx and dw each per launch, beside the plain
    versions (``x @ w.to(bf16)`` and autograd's vjp of it, the cast
    included), the library yardstick (cuBLAS's ``x @ w_bf16``, ``dy @
    w_bf16.T``, ``x.T @ dy`` with the bf16 weight made beforehand) and the
    cast's own time, and the bound (operations at the bf16 peak), with the
    launches a warm fused gradient makes of each.  Returns the kernels
    line's rows, at gemma2-2b's gate/up shape."""
    import numpy as np

    from repro_torch.kernels import dense as dn

    src = "src/repro_torch/kernels/csrc/dense.cu"
    # the segment kernels whose traced body computed them: the forward in
    # the advance's chunk scans, the backward in the reverse's chunk vjp
    rep = "src/repro/kernels/segment_pallas.py:"
    rng = np.random.default_rng(74)
    bf16 = torch.bfloat16
    pinned = {k: state["launches_by_phase"].get(f"{k}-fused-pinned", {})
              for k in ("dense", "ssm")}
    # projections of each shape a chain step, of all a step
    share = {"gemma2-2b": (14, {"wq": 2, "wk, wv": 4, "wo": 2,
                                "gate, up": 4, "down": 2}),
             "mamba2-370m": (2, {"in_proj": 1, "out_proj": 1})}
    rows, table = [], []
    for label, (M, K, N) in DENSE_CASES:
        arch, proj = label.split(" ", 1)
        x = _randn(torch, rng, (M, K), bf16)
        w = _randn(torch, rng, (K, N), torch.float32, K ** -0.5)
        dy = _randn(torch, rng, (M, N), bf16)
        wb = w.to(bf16)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * M * K + 4.0 * K * N + 2.0 * M * N
        ms = {"fwd": cuda_ms(lambda: dn.dense_fwd(x, w), 20),
              "dx": cuda_ms(lambda: dn.dense_bwd(dy, x, w, need_dw=False),
                            20),
              "dw": cuda_ms(lambda: dn.dense_bwd(dy, x, w, need_dx=False),
                            20),
              "plain": cuda_ms(lambda: dn.dense_fwd_plain(x, w), 5),
              "plain_bwd": cuda_ms(lambda: dn.dense_bwd_plain(dy, x, w), 5),
              "lib": cuda_ms(lambda: x @ wb, 20),
              "lib_dx": cuda_ms(lambda: dy @ wb.T, 20),
              "lib_dw": cuda_ms(lambda: x.T @ dy, 20),
              "cast": cuda_ms(lambda: w.to(bf16), 20)}
        b_ms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS)
        key = "dense" if arch == "gemma2-2b" else "ssm"
        of, each = share[arch]
        n_fwd = pinned[key].get("dense_fwd", 0) * each[proj] // of
        n_bwd = pinned[key].get("dense_bwd", 0) * each[proj] // of
        tf = {k: flops / ms[k] / 1e9 for k in ("fwd", "dx", "dw")}
        log(f"[timing] dense {label} (M={M}, K={K}, N={N}): forward "
            f"{ms['fwd']:.4f} ms ({tf['fwd']:.1f} TFLOP/s), dx "
            f"{ms['dx']:.4f} ({tf['dx']:.1f}), dw {ms['dw']:.4f} "
            f"({tf['dw']:.1f}); bound {b_ms:.4f} ms each by {by}; plain "
            f"{ms['plain']:.4f} (backward {ms['plain_bwd']:.4f}); cuBLAS "
            f"{ms['lib']:.4f}, dx {ms['lib_dx']:.4f}, dw {ms['lib_dw']:.4f},"
            f" the cast {ms['cast']:.4f}; launches in the pinned fused "
            f"gradient {n_fwd} forward, {n_bwd} backward")
        table.append((label, ms, b_ms, n_fwd, n_bwd))
        if proj in ("wo", "out_proj"):
            # the main path's form here: the pre-norm's skip added in the
            # epilogue (the residual read once more)
            res = _randn(torch, rng, (M, N), bf16)
            t_res = timing_alt(
                "dense_fwd", lambda: dn.dense_fwd(x, w, res),
                nbytes + 2.0 * M * N, f"{label} with the residual")
            log(f"[timing] dense {label}: the residual epilogue adds "
                f"{t_res - ms['fwd']:.4f} ms to the product's "
                f"{ms['fwd']:.4f}; PyTorch's add of two such tensors (the "
                f"add it replaces) {cuda_ms(lambda: res + res, 20):.4f} ms")
            del res
        if proj == "gate, up":
            rows.append(("dense_fwd", src, rep + "248", ms["fwd"],
                         ms["plain"], b_ms, by, ms["lib"], flops))
            b2, by2 = bound_ms(2 * nbytes, 2 * flops, BF16_TC_FLOPS)
            rows.append(("dense_bwd", src, rep + "456", ms["dx"] + ms["dw"],
                         ms["plain_bwd"], b2, by2,
                         ms["lib_dx"] + ms["lib_dw"], 2 * flops))
        del x, w, dy, wb
        torch.cuda.empty_cache()
    state["dense_timing"] = table
    return rows


def _time_moe(torch, state):
    """The MoE layer's kernels at phi3.5-moe's layer (``MOE_LAYER`` at the
    config's capacity, C = 640: the moe phase's shape), each beside its
    plain version and its bound (bytes at 3.35 TB/s: every input read once,
    only the kept rows of a gather, every output written once; the
    experts' products: operations at the bf16 peak), and the one-call
    library yardstick where there is one: ``index_select`` for the
    dispatch, ``index_add_`` for its vjp, ``torch.bmm`` on bf16 weights
    made beforehand plus the cast for the experts' products (both shapes
    logged; the rows at gate/up's).  Returns the kernels line's rows."""
    import numpy as np

    from repro_torch.kernels import dense as dn
    from repro_torch.kernels import moe as mk
    from repro_torch.models.moe import _capacity

    G, S, d, E, k, f = MOE_LAYER
    N = G * S
    C = _capacity(S, E, k, MOE_CFS[0])
    src = "src/repro_torch/kernels/csrc/"
    # the TPU kernels whose traced body computed them (src/repro/models/
    # moe.py:81-161): the forward in the advance's chunk scans, the
    # backward in the reverse's chunk vjp
    rep_ = "src/repro/kernels/segment_pallas.py:"
    rng = np.random.default_rng(76)
    bf16 = torch.bfloat16
    x, w, (weights, idx, probs, _, ce) = _moe_inputs(torch, rng)
    choice_slot, slot_src, _ = mk.moe_slots(idx, E, C)
    kept = int((slot_src >= 0).sum())
    rows_bytes = 2.0 * kept * d          # the kept rows a gather reads
    nk, egc = N * k, E * G * C
    dweights = _randn(torch, rng, (G, S, k), torch.float32)
    daux = torch.tensor(0.7, device="cuda")
    out = []

    def row(name, cu, k_fn, p_fn, nbytes, flops=0.0, l_fn=None, what=""):
        line = "456" if name.endswith("_bwd") else "248"
        out.append(timing_row(name, src + cu, rep_ + line, k_fn, p_fn,
                              nbytes, flops, l_fn, what, iters=(20, 3)))

    # the routing with its aux loss (the probs and choices read again by
    # the aux's block: counted once, as written)
    row("moe_route", "moe.cu", lambda: mk.moe_route(x, w, k),
        lambda: (mk.route_plain(x, w, k),
                 mk.aux_plain(probs, idx, E)),
        2.0 * N * d + 4.0 * d * E + 4.0 * N * E + 12.0 * nk + 4.0 * E + 4.0,
        what=f" at ({G}, {S}, {d}) bf16, E={E}, top-{k}, with the aux loss")
    row("moe_route_bwd", "moe.cu",
        lambda: mk.moe_route_bwd(dweights, daux, x, w, probs, idx, ce),
        lambda: mk.route_bwd_plain(dweights, daux, x, w, k),
        4.0 * N * d + 8.0 * d * E + 4.0 * N * E + 12.0 * nk + 4.0 * E,
        what=" (the weights' and the aux's cotangents)")
    row("moe_slots", "moe.cu", lambda: mk.moe_slots(idx, E, C),
        lambda: mk.slots_plain(idx, E, C),
        8.0 * nk + 4.0 * nk + 4.0 * egc + 4.0 * G * E,
        what=f" (C={C}, {kept} of {nk} choices kept)")
    xp = torch.cat([x.reshape(N, d), x.new_zeros((1, d))])
    tok = torch.where(slot_src >= 0, slot_src // k, N).long().reshape(-1)
    row("moe_dispatch", "moe.cu",
        lambda: mk.moe_dispatch(x, slot_src, k),
        lambda: mk.dispatch_plain(x, slot_src, k),
        4.0 * egc + rows_bytes + 2.0 * egc * d,
        l_fn=lambda: xp.index_select(0, tok),
        what=" (library: index_select of x with a zero row appended)")
    dexp = _randn(torch, rng, (E, G * C, d), bf16)
    dexp2 = _randn(torch, rng, (E, G * C, d), bf16)
    acc = x.new_zeros((N + 1, d))
    dexp_flat = dexp.reshape(-1, d)
    # the main path's form: the gate's and the up product's cotangents of
    # the buckets summed in the kernel (no one PyTorch call computes it)
    row("moe_dispatch_bwd", "moe.cu",
        lambda: mk.moe_dispatch_bwd(dexp, choice_slot, dexp2),
        lambda: mk.dispatch_bwd_plain(dexp + dexp2, choice_slot),
        4.0 * nk + 2 * rows_bytes + 2.0 * N * d,
        what=" (the gate's and up's cotangents of the buckets)")
    timing_alt("moe_dispatch_bwd", lambda: mk.moe_dispatch_bwd(
        dexp, choice_slot), 4.0 * nk + rows_bytes + 2.0 * N * d,
        "from one cotangent (the row's form before)")
    timing_alt("index_add_", lambda: acc.index_add_(0, tok, dexp_flat),
               4.0 * nk + rows_bytes + 2.0 * N * d,
               "of the bucket rows into the tokens' (the library yardstick "
               "of the row's form before)")
    res = _randn(torch, rng, (G, S, d), bf16)
    # the main path's form: the layer's skip added in the kernel
    row("moe_combine", "moe.cu",
        lambda: mk.moe_combine(dexp, weights, choice_slot, bf16, res),
        lambda: mk.combine_plain(dexp, weights, choice_slot, bf16, res),
        8.0 * nk + rows_bytes + 2 * 2.0 * N * d,
        what=" (with the residual)")
    timing_alt("moe_combine", lambda: mk.moe_combine(
        dexp, weights, choice_slot, bf16), 8.0 * nk + rows_bytes
        + 2.0 * N * d, "without the residual (the row's form before)")
    del dexp2, res
    dy = _randn(torch, rng, (G, S, d), bf16)
    row("moe_combine_bwd", "moe.cu",
        lambda: mk.moe_combine_bwd(dy, dexp, weights, choice_slot, slot_src),
        lambda: mk.combine_bwd_plain(dy, dexp, weights, choice_slot,
                                     slot_src),
        2.0 * N * d + 8.0 * nk + 4.0 * egc + rows_bytes + 2.0 * egc * d
        + 4.0 * nk)
    del xp, tok, dexp, acc, dexp_flat, dy
    torch.cuda.empty_cache()
    M = G * C
    for label, K, Nn in (("gate/up", d, f), ("down", f, d)):
        xe = _randn(torch, rng, (E, M, K), bf16)
        we = _randn(torch, rng, (E, K, Nn), torch.float32, K ** -0.5)
        dye = _randn(torch, rng, (E, M, Nn), bf16)
        wb = we.to(bf16)
        flops = 2.0 * E * M * K * Nn
        nbytes = 2.0 * E * M * K + 4.0 * E * K * Nn + 2.0 * E * M * Nn
        ms = {"cast": cuda_ms(lambda: we.to(bf16), 10),
              "bmm": cuda_ms(lambda: torch.bmm(xe, wb), 10),
              "bmm_dx": cuda_ms(lambda: torch.bmm(dye, wb.transpose(1, 2)),
                                10),
              "bmm_dw": cuda_ms(lambda: torch.bmm(xe.transpose(1, 2), dye),
                                10)}
        fwd = timing_row(
            "expert_fwd", src + "dense.cu", rep_ + "248",
            lambda: dn.expert_fwd(xe, we), lambda: dn.expert_fwd_plain(xe, we),
            nbytes, flops, lambda: torch.bmm(xe, wb), iters=(10, 3),
            what=f" {label} (E={E}, M={M}, K={K}, N={Nn})")
        bwd = timing_row(
            "expert_bwd", src + "dense.cu", rep_ + "456",
            lambda: dn.expert_bwd(dye, xe, we),
            lambda: dn.expert_bwd_plain(dye, xe, we),
            2.0 * nbytes, 2.0 * flops,
            lambda: (torch.bmm(dye, wb.transpose(1, 2)),
                     torch.bmm(xe.transpose(1, 2), dye)),
            iters=(10, 3), what=f" {label}")
        log(f"[timing] experts {label}: forward {fwd[3]:.4f} ms "
            f"({flops / fwd[3] / 1e9:.1f} TFLOP/s), backward {bwd[3]:.4f} ms "
            f"({2 * flops / bwd[3] / 1e9:.1f}); cuBLAS bmm {ms['bmm']:.4f}, "
            f"dx {ms['bmm_dx']:.4f}, dw {ms['bmm_dw']:.4f}, the cast "
            f"{ms['cast']:.4f} ms; bound {fwd[5]:.4f} ms a product")
        if label == "gate/up":   # the rows: bmm with the bf16 weight and
            # the cast that makes it
            out.append(fwd[:7] + (fwd[7] + ms["cast"], fwd[8]))
            out.append(bwd[:7] + (bwd[7] + ms["cast"], bwd[8]))
        del xe, we, dye, wb
        torch.cuda.empty_cache()
    return out


def ssd_bwd_flops(B, T, H, G, P, N, L) -> float:
    """The SSD backward's multiply-adds x 2, per chunk: the chunk's state
    and its cotangent's input (two P x N x L products), dx's two products
    with the state and its cotangent and dc's and db's with them (four P x N
    x L), the causal halves of dM, M^T dy (L x L x P each) and of dc's and
    db's products with dcb (L x L x N each); C B^T's causal half once a
    group."""
    nc = -(-T // L)
    head = 12.0 * L * P * N + 2.0 * L * L * P + 2.0 * L * L * N
    return B * nc * (H * head + G * L * L * N)


def _time_mamba_kernels(torch):
    """mamba2-370m's layer kernels at the ssm phase's shape (B=4, T=4096,
    bf16), each beside its plain version, its bound (bytes at 3.35 TB/s,
    every input read once and every output written once; the SSD backward's
    operations at the bf16 tensor-core peak) and, where one PyTorch call
    computes the same function, that call: ``F.conv1d(groups=C)`` for the
    conv (without its SiLU) and ``F.softplus`` on the fp32 sum for the
    step sizes.  Returns the kernels line's rows."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.kernels import ssd_scan as ssd

    csrc = "src/repro_torch/kernels/csrc/"
    rep = "src/repro/kernels/segment_pallas.py:456"   # the reverse's vjp
    rep_f = "src/repro/kernels/segment_pallas.py:248"
    rows = []
    rng = np.random.default_rng(73)
    bf16, f32 = torch.bfloat16, torch.float32
    B, T, H, G, P, N, L = MAMBA_SSD
    C, K = MAMBA_CONV
    d = H * P

    def row(name, src, replaces, k_fn, p_fn, nbytes, flops=0.0, l_fn=None,
            what=""):
        return timing_row(name, csrc + src, replaces, k_fn, p_fn, nbytes,
                          flops, l_fn, what, iters=(10, 3))

    # the SSD backward as the model calls it: no entry state, the final
    # state's cotangent a zero tensor
    args = list(_ssd_bwd_args(torch, rng, MAMBA_SSD, "bfloat16", False))
    args[7] = torch.zeros_like(args[7])
    x_b = B * T * H * P * 2.0
    bc_b = 2 * B * T * G * N * 2.0
    nbytes = (2 * x_b + bc_b + B * T * H * 4.0 + H * 4.0 + B * H * P * N * 4.0
              + x_b + bc_b + B * T * H * 4.0 + H * 4.0)
    rows.append(row("ssd_scan_bwd", "ssd_scan_bwd.cu", rep,
                    lambda: ssd.ssd_scan_bwd(*args, chunk=L),
                    lambda: ssd.ssd_scan_bwd_plain(*args, chunk=L), nbytes,
                    ssd_bwd_flops(B, T, H, G, P, N, L),
                    what=f" at {MAMBA_SSD} bf16"))
    del args
    torch.cuda.empty_cache()
    proj = _randn(torch, rng, (B, T, 2 * d + 2 * G * N + H), bf16)
    z, xbc, raw = proj[..., :d], proj[..., d:d + C], proj[..., d + C:]
    # the input projection's cotangent, whose columns the backwards write
    dproj = torch.empty_like(proj)
    w = _randn(torch, rng, (K, C), bf16, 0.2)
    bias = _randn(torch, rng, (C,), bf16, 0.1)
    wl = w.t().contiguous().unsqueeze(1)    # (C, 1, K)
    xl = xbc.transpose(1, 2)
    splits = (d, G * N, G * N)

    def conv_lib():
        return F.conv1d(xl, wl, bias, padding=K - 1, groups=C)

    n = B * T * C
    # the main path's forms (the mixer owns the split): the conv reads its
    # columns in place and writes x, B and C apart; its backward reads the
    # SSD's three cotangents and the gated norm's skip cotangent on x and
    # writes its columns of the projection's cotangent
    rows.append(row("causal_conv", "causal_conv.cu", rep_f,
                    lambda: cc.causal_conv(xbc, w, bias, splits=splits),
                    lambda: cc.causal_conv_plain(xbc, w, bias, None),
                    2 * 2.0 * n + 2.0 * (K + 1) * C, 0.0, conv_lib,
                    f" at ({B}, {T}, {C}) bf16, K={K}, into x, B and C "
                    "(library: F.conv1d, groups=C, without the SiLU)"))
    timing_alt("causal_conv", lambda: cc.causal_conv(xbc, w, bias),
               2 * 2.0 * n + 2.0 * (K + 1) * C,
               "into one tensor (the row's form before)", iters=10)
    pieces = cc.causal_conv(xbc, w, bias, splits=splits)
    gp = [_randn(torch, rng, t.shape, bf16) for t in pieces]
    gadd = _randn(torch, rng, gp[0].shape, bf16)
    g = torch.cat([gp[0] + gadd] + gp[1:], dim=-1)
    rows.append(row("causal_conv_bwd", "causal_conv.cu", rep,
                    lambda: cc.causal_conv_bwd(
                        tuple(gp), xbc, w, bias, g_add=gadd,
                        dx_out=dproj[..., d:d + C]),
                    lambda: cc.causal_conv_bwd_plain(g, xbc, w, bias, None),
                    3 * 2.0 * n + 2.0 * B * T * d + 2 * 2.0 * (K + 1) * C,
                    what=" (from the SSD's pieces and the skip's addend, "
                    "into its columns of the projection's cotangent)"))
    timing_alt("causal_conv_bwd", lambda: cc.causal_conv_bwd(
        g, xbc, w, bias), 3 * 2.0 * n + 2 * 2.0 * (K + 1) * C,
        "from one cotangent into its own tensor (the row's form before)",
        iters=10)
    dtb = _randn(torch, rng, (H,), f32)
    v = raw.float() + dtb
    rows.append(row("dt_softplus", "dt_softplus.cu", rep_f,
                    lambda: ds.dt_softplus(raw, dtb),
                    lambda: ds.dt_softplus_plain(raw, dtb),
                    B * T * H * (2.0 + 4.0) + 4.0 * H, 0.0,
                    lambda: F.softplus(v),
                    " (library: F.softplus on the fp32 sum)"))
    gd = _randn(torch, rng, (B, T, H), f32)
    rows.append(row("dt_softplus_bwd", "dt_softplus.cu", rep,
                    lambda: ds.dt_softplus_bwd(gd, raw, dtb,
                                               draw_out=dproj[..., d + C:]),
                    lambda: ds.dt_softplus_bwd_plain(gd, raw, dtb),
                    B * T * H * (2.0 + 4.0 + 2.0) + 8.0 * H,
                    what=" (into its columns of the projection's "
                    "cotangent)"))
    y = _randn(torch, rng, (B, T, H, P), bf16)
    x = pieces[0].view(B, T, H, P)
    D = _randn(torch, rng, (H,), f32)
    scale = _randn(torch, rng, (d,), f32, 0.3)
    m = B * T * d
    rows.append(row("gated_norm", "gated_norm.cu", rep_f,
                    lambda: gn.gated_norm(y, x, D, z, scale, out_dtype=bf16),
                    lambda: gn.gated_norm_plain(y, x, D, z, scale, 1e-6,
                                                bf16),
                    4 * 2.0 * m + 4.0 * (B * T + H + d),
                    what=f" at ({B * T}, {d}) bf16"))
    _, rstd = gn.gated_norm(y, x, D, z, scale, out_dtype=bf16)
    gg = _randn(torch, rng, (B, T, d), bf16)
    rows.append(row("gated_norm_bwd", "gated_norm.cu", rep,
                    lambda: gn.gated_norm_bwd(gg, y, x, D, z, scale, rstd,
                                              dz_out=dproj[..., :d]),
                    lambda: gn.gated_norm_bwd_plain(gg, y, x, D, z, scale,
                                                    1e-6, bf16),
                    7 * 2.0 * m + 4.0 * (B * T + 2 * (H + d)),
                    what=" (dz into its columns of the projection's "
                    "cotangent)"))
    del proj, dproj, pieces, gp, gadd, g, v, gd, y, x, gg, rstd
    torch.cuda.empty_cache()
    return rows


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
    rows += _time_generic(torch)
    rows += _time_layer_kernels(torch, state)
    rows += _time_mamba_kernels(torch)
    rows += _time_dense(torch, state)
    rows += _time_moe(torch, state)

    out = []
    for name, src, rep, k_ms, p_ms, b_ms, by, l_ms, flops in rows:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": state["launches"][name],
                    "max_abs_err": state["err"][name], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": l_ms})
        rate = f"; {flops / k_ms / 1e9:.2f} TFLOP/s" if flops else ""
        log(f"[timing] {name}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by}, library "
            f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}{rate}); "
            f"launches {state['launches'][name]}")
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
                or e.key in CALLERS or e.key.startswith(RANGES):
            continue   # a range's device span, not a kernel
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


# the fused segment wrappers' profiler ranges (segment_fused._card_call,
# CapturedRun), and the ranges of their parts and of _HostSplit
CALLERS = ("fused_advance_segment", "fused_reverse_segment")
RANGES = ("fused.", "split.")


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


class _HostSplit:
    """Host milliseconds of offloaded gradients by part: each part a
    ``torch.profiler.record_function`` range timed with ``perf_counter`` on
    the thread that runs it, exclusive of the parts nested in it (the
    executor's own bookkeeping is the executor's time less the runner's and
    the store's calls it makes).  Installed by wrapping the functions named
    in :meth:`install`; :meth:`remove` puts them back."""

    def __init__(self):
        import threading

        self.ms = {}
        self.calls = {}
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._undo = []

    @contextlib.contextmanager
    def timed(self, part: str):
        import torch

        stack = self._tls.__dict__.setdefault("stack", [])
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"split.{part}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            nested = stack.pop()
            if stack:
                stack[-1] += dt
            with self._lock:
                self.ms[part] = self.ms.get(part, 0.0) + 1e3 * (dt - nested)
                self.calls[part] = self.calls.get(part, 0) + 1

    def wrap(self, owner, attr: str, part: str) -> None:
        import functools

        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def timed_call(*args, **kwargs):
            with self.timed(part):
                return orig(*args, **kwargs)

        setattr(owner, attr, timed_call)
        self._undo.append((owner, attr, orig))

    def install(self) -> "_HostSplit":
        from repro_torch.api import autotune, frontend
        from repro_torch.core import compiled_ops, executor, storage
        from repro_torch.kernels import segment_fused as sf

        eng = storage.AsyncTransferEngine
        for owner, attr, part in (
                (frontend, "_fwd", "front door"),
                (frontend, "_bwd", "front door"),
                (autotune.AutoTuner, "measure", "front door"),
                (executor.CheckpointExecutor, "multistage_forward",
                 "executor"),
                (executor.CheckpointExecutor, "multistage_reverse",
                 "executor"),
                (compiled_ops.FusedSegmentRunner, "advance_with_store",
                 "runner"),
                (compiled_ops.FusedSegmentRunner, "advance", "runner"),
                (compiled_ops.FusedSegmentRunner, "reverse", "runner"),
                (sf, "_advance_lstm_cuda", "wrapper: launches"),
                (sf, "_reverse_lstm_cuda", "wrapper: launches"),
                (sf.CapturedRun, "advance", "wrapper: launches"),
                (sf.CapturedRun, "reverse", "wrapper: launches"),
                (eng, "store_async", "store enqueue"),
                (eng, "cursor_async", "store enqueue"),
                (eng, "prefetch_async", "prefetch enqueue"),
                (eng, "wait_prefetch", "prefetch wait"),
                (eng, "delete", "delete"),
                (eng, "delete_async", "delete"),
                (eng, "wait_stores", "wait_stores"),
                (executor, "tree_bytes", "stats"),
                (executor._L1Slots, "note_extra", "stats"),
                (storage.HostTree, "wait", "thread: store event wait"),
                (eng, "_put", "thread: store put"),
                (eng, "_fetch", "thread: prefetch fetch")):
            self.wrap(owner, attr, part)
        parts = {"fused.alloc": "wrapper: allocations",
                 "fused.args": "wrapper: argument block",
                 "fused.replay": "wrapper: graph replay"}
        orig_part = sf._part

        @contextlib.contextmanager
        def part(name):
            with self.timed(parts.get(name, name)):
                yield

        sf._part = part
        self._undo.append((sf, "_part", orig_part))
        return self

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def report(self, label: str, segments: int, wall_s: float) -> dict:
        """Log the split in ms per segment and return it.  The parts run
        one after another on the calling thread and on autograd's device
        thread (which runs the backward while the caller waits); what is
        left of the wall is the front door's own work and the final
        synchronisation ("rest").  The Level-2 threads' parts ("thread:")
        run beside them."""
        ms = dict(self.ms)
        serial = sum(v for k, v in ms.items() if not k.startswith("thread:"))
        ms["rest"] = 1e3 * wall_s - serial
        per = {k: v / segments for k, v in sorted(ms.items(),
                                                   key=lambda kv: -kv[1])}
        log(f"[profile] {label}: host split of one warm call over "
            f"{segments} segments, ms per segment (wall {wall_s:.4f}s = "
            f"{1e3 * wall_s / segments:.4f} ms a segment):")
        for k, v in per.items():
            log(f"[profile]   {v:9.4f}  {k} ({self.calls.get(k, 1)} calls)")
        return per


def host_split(call, label: str, segments: int) -> dict:
    """:class:`_HostSplit` of one ``call()``, without the profiler."""
    import torch

    split = _HostSplit().install()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        split.remove()
    return split.report(label, segments, wall)


def advance_call_times(state, T: int) -> None:
    """One fused advance of ``T`` steps (its chunk ``T``, as the autotuner's
    probe runs it) captured and uncaptured, on ``train_4k``'s first steps:
    host milliseconds a call synchronised after each (what the probe times)
    and back to back (20 calls, one synchronisation), and device
    milliseconds a call (CUDA events)."""
    import torch

    from repro_torch.kernels import segment_fused as sf
    from repro_torch.models import lstm

    spec = lstm.train_chain()
    params = state["params"]
    carry0, xs = spec.prelude(params, state["batch"])
    xs = tuple(x[:T].contiguous() for x in xs)
    run = sf.CapturedRun(spec.body, params, xs)
    calls = {"captured": lambda: run.advance(carry0, 0, T, T, last=False),
             "uncaptured": lambda: sf.fused_advance_segment(
                 spec.body, params, carry0, xs, None, chunk=T)}
    out = []
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
            torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / 20
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        out.append(f"{name} {1e3 * synced:.4f} ms synchronised, "
                   f"{1e3 * (time.perf_counter() - t0) / 20:.4f} ms back "
                   "to back")
    device_ms = {name: cuda_ms(call, 20) for name, call in calls.items()}
    log(f"[profile] fused advance of T={T} (its probe's chunk), a call: "
        f"{'; '.join(out)}; device time a call (CUDA events): captured "
        f"{device_ms['captured']:.4f} ms, uncaptured "
        f"{device_ms['uncaptured']:.4f} ms")


# the decoders phase profile times: arch -> (its phase, its batch)
# arch -> (phase, batch, depth cut or None)
PROFILE_ARCHS = {"gemma2-2b": ("dense", 2, None),
                 "mamba2-370m": ("ssm", 4, None),
                 "phi3.5-moe-42b": ("moe", 2, MOE_LAYERS)}


def profile_fused(state) -> None:
    """Device time of one warm fused gradient by kernel for each arch of
    ``--profile-archs`` at its phase's pinned schedule (``FUSED_PINNED``),
    split into the hand-written kernels, the cuBLAS products and PyTorch's
    own, with its warm walls autotuned and pinned (``tools/profile_fused.py``,
    each tree and arch in a process of its own): the tree given with
    ``--parent`` (a ``git archive`` of another commit) first, then this
    one, whose cuBLAS products must be the readout's alone
    (``--readout-only``) and whose fused segments' body ranges must launch
    no PyTorch kernel on a tensor with a token axis (``--body-only``: the
    device time split by range, and the body's PyTorch kernels listed); the
    tables to ``<out-dir>/profile_<arch>_*.txt``."""
    import torch

    torch.cuda.empty_cache()
    trees = [("parent", state["parent"])] if state.get("parent") else []
    trees.append(("tree", ROOT))
    for arch in state["profile_archs"]:
        key, batch, layers = PROFILE_ARCHS[arch]
        interval, slots = FUSED_PINNED[key]
        for label, root in trees:
            out = os.path.join(state["out_dir"],
                               f"profile_{arch}_{label}.txt")
            res = subprocess.run(
                [sys.executable, os.path.join(ROOT, "tools",
                                              "profile_fused.py"),
                 "--arch", arch, "--batch", str(batch), "--interval",
                 str(interval), "--slots", str(slots), "--src",
                 os.path.join(root, "src"), "--out", out, "--label", label]
                + (["--layers", str(layers)] if layers else [])
                + (["--readout-only", "--body-only"] if label == "tree"
                   else []),
                capture_output=True, text=True, timeout=900)
            require(res.returncode == 0, f"profile of {arch} ({label}) "
                    f"failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
            for line in res.stdout.splitlines():
                log(line)


def phase_profile(state) -> None:
    """Where one offloaded LSTM gradient's time goes, per schedule of the
    main phase (the decoder phases profile themselves when ``profile`` is
    among the phases): the host split of a warm call by part
    (:class:`_HostSplit`), captured and uncaptured, then device time by
    kernel and the device's busy share under the profiler, the same two
    ways."""
    from repro_torch import api
    from repro_torch.kernels import segment_fused as sf

    profile_fused(state)
    if "runs" not in state:   # phase main did not run
        return
    model, params, batch = state["model"], state["params"], state["batch"]
    splits = state.setdefault("host_split", {})
    for T in sorted({32, state["runs"][0]["interval"]}):
        advance_call_times(state, T)
    for run in state["runs"]:
        kw = {"interval": run["interval"]} if run["label"] == "pinned" \
            else {}
        vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                          device="cuda", **kw)
        vg(params, batch)   # warm: the schedule is cached, kernels loaded
        segs = api.last_plan().num_segments
        for how in ("captured", "uncaptured"):
            sf._CAPTURED = how == "captured"
            try:
                vg(params, batch)
                label = f"{run['label']} {how}"
                splits[label] = host_split(lambda: vg(params, batch), label,
                                           segs)
                profile_call(state, f"{run['label']}_{how}",
                             f"I={run['interval']}, {how}",
                             lambda: vg(params, batch))
            finally:
                sf._CAPTURED = True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPTIONAL))
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="directory for the build log and profile tables")
    ap.add_argument("--parent", default=None,
                    help="phase profile: also profile the fused decoder "
                    "gradients of the checkout in this directory (a git "
                    "archive of another commit)")
    ap.add_argument("--profile-archs", default=",".join(PROFILE_ARCHS),
                    help="phase profile: the decoders to profile, of "
                    + ",".join(PROFILE_ARCHS))
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
             "profile": "profile" in phases,
             "parent": args.parent and os.path.abspath(args.parent),
             "profile_archs": [a for a in args.profile_archs.split(",")
                               if a]}
    steps = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "main": phase_main,
             "scan": phase_scan,
             "strategies": phase_strategies, "level2": phase_level2,
             "resume": phase_resume,
             "dense": phase_dense, "ssm": phase_ssm, "moe": phase_moe,
             "families": phase_families, "timing": phase_timing, "train": phase_train,
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

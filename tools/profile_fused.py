#!/usr/bin/env python3
"""Device time of one warm fused decoder gradient on the card, by kernel.

    python3 tools/profile_fused.py [--arch NAME] [--batch B] [--interval I]
        [--slots S] [--layers L] [--src DIR] [--out FILE] [--readout-only]

Runs ``value_and_grad_offloaded(get_model(NAME).train_loss,
runner="fused", interval=I, slots=S)`` (by default gemma2-2b at I=13, s=4
and B=2, ``chip_smoke.py``'s phase ``dense`` at its pinned schedule;
``--arch mamba2-370m --batch 4 --interval 14`` is phase ``ssm``'s and
``--arch phi3.5-moe-42b --layers 4 --interval 2 --slots 2`` phase
``moe``'s: full width, ``train_4k`` with the batch cut to B, the depth cut
to L layers where given, weights from a seeded CUDA generator) with the
``repro_torch`` package found under ``DIR``
(default: this checkout's ``src``; give a ``git archive`` of another
commit's tree to compare): first two autotuned calls (the second's wall
is the warm autotuned one), then at the pinned schedule twice to warm up
(their device peak above what was allocated before them printed) and
once under ``torch.profiler``.  Prints the walls, the device's busy
time and that time split three ways: the hand-written kernels (every
``__global__`` function of ``DIR/repro_torch/kernels/csrc``), the cuBLAS
products (kernel names with ``gemm``, ``cutlass``, ``xmma`` or ``nvjet``)
and the rest (PyTorch's own kernels); writes the table by kernel to
``FILE``.  Counts the cuBLAS products (its launches less the split-K
reductions that follow a split product) beside the readout's (the loss
head, ``layers.chunked_ce_loss``: each sequence chunk's logits in the
forward and in its checkpoint's recompute, and their two gradient
products); ``--readout-only`` exits 1 unless the two are equal, that is
unless the chain body launches no cuBLAS product.

``--body-only`` assigns each device kernel to the profiler range of the
generic fused segments (``kernels/segment_generic.py``: ``generic.advance``,
the chunks' steps; ``generic.reverse``, the recompute, each chunk's vjp and
its fold) that was open when it was launched: the kernel's launch is found
by its correlation id in the exported trace, and its timestamp placed in
the ranges' intervals by time, not by thread (autograd launches a
backward's kernels from a thread of its own).  It prints the device time
of each range by kind, and each PyTorch kernel inside the ranges with its
launches, time, the ATen operator that launched it and its largest input;
it exits 1 if any of those inputs has a token axis (leading ``(B, S)`` or
``B S`` rows).  Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARY = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
# profiler ranges whose device spans are not kernels
RANGES = ("fused.", "split.", "generic.")
BODY = ("generic.advance", "generic.reverse")


def hand_written(src: str) -> set:
    """The ``__global__`` function names of the package's CUDA sources."""
    csrc = os.path.join(src, "repro_torch", "kernels", "csrc")
    names = set()
    for fn in os.listdir(csrc):
        with open(os.path.join(csrc, fn)) as f:
            text = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            text))
    return names


def kind(name: str, ours: set) -> str:
    """A profiled kernel's kind: one of ``ours`` (by its name, at the top
    level or in an anonymous namespace, not a namesake in another namespace
    such as ``at::native::reduce_kernel``), a cuBLAS product, or PyTorch's."""
    if any(re.search(rf"(?:^|[^\w:]|\(anonymous namespace\)::){n}\b", name)
           for n in ours):
        return "hand-written"
    if any(k in name.lower() for k in LIBRARY):
        return "cuBLAS"
    return "PyTorch"


def _largest(dims):
    """The largest shape (by element count) among a trace's ``Input Dims``
    (tensor lists nest a level deeper), or None."""
    best = None
    for d in dims or ():
        if d and isinstance(d[0], list):
            cand = _largest(d)
        elif d and all(isinstance(v, int) for v in d):
            cand = d
        else:
            continue
        if cand is not None and (best is None or math.prod(cand)
                                 > math.prod(best)):
            best = cand
    return best


def token_axis(shape, B: int, S: int) -> bool:
    """Whether a tensor of ``shape`` runs over the tokens: leading
    ``(B, S)``, or ``B S`` rows."""
    return bool(shape) and (list(shape[:2]) == [B, S] or shape[0] == B * S)


def body_split(trace: str, ours: set, B: int, S: int):
    """From an exported trace: ``(by_range, pytorch)``.  ``by_range``: range
    name ("outside" for none) -> kind -> device ms; ``pytorch``: (kernel,
    operator, largest input) -> [launches, device ms] for PyTorch's kernels
    launched inside a body range."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    ranges, launches, kernels, ops = [], {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat == "user_annotation" and e.get("name") in BODY:
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat == "kernel":
            kernels.append(e)
        elif cat == "cpu_op":
            ops.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"],
                 args.get("Input Dims")))
    ranges.sort()
    starts = [r[0] for r in ranges]
    for v in ops.values():
        v.sort(key=lambda o: (o[0], -o[1]))
    op_starts = {tid: [o[0] for o in v] for tid, v in ops.items()}

    def where(t):
        i = bisect.bisect_right(starts, t) - 1
        # the ranges do not nest, so only the last one begun can hold t
        return ranges[i][2] if i >= 0 and t <= ranges[i][1] else "outside"

    def operator(tid, t):
        # the innermost operator open on the launching thread: the last one
        # begun that has not ended (a thread's operators nest)
        v = ops.get(tid, [])
        for i in range(bisect.bisect_right(op_starts.get(tid, []), t) - 1,
                       -1, -1):
            if v[i][1] >= t:
                return v[i][2], v[i][3]
        return None

    by_range, pytorch = {}, {}
    for k in kernels:
        ms = k["dur"] / 1e3
        launch = launches.get(k.get("args", {}).get("correlation"))
        rng = where(launch[1]) if launch else "outside"
        kd = kind(k["name"], ours)
        split = by_range.setdefault(rng, {})
        split[kd] = split.get(kd, 0.0) + ms
        if rng == "outside" or kd != "PyTorch":
            continue
        op = operator(*launch) if launch else None
        name, dims = op if op else ("?", None)
        shape = _largest(dims)
        key = (k["name"], name, tuple(shape) if shape else ())
        n, t = pytorch.get(key, (0, 0.0))
        pytorch[key] = (n + 1, t + ms)
    return by_range, pytorch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--interval", type=int, default=13)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (phi3.5-moe's "
                    "full depth does not fit the card)")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default=None)
    ap.add_argument("--readout-only", action="store_true",
                    help="fail unless every cuBLAS launch is the readout's")
    ap.add_argument("--body-only", action="store_true",
                    help="fail if a PyTorch kernel inside a fused segment's "
                    "body range reads a tensor with a token axis")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_fused: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import api
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.kernels import build
    from repro_torch.models.model_factory import get_model

    label = args.label or src
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    full = SHAPES["train_4k"]
    shape = ShapeSpec(full.name, full.seq_len, args.batch, full.kind)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = make_batch(cfg, shape, seed=0)

    def walls_of(vg):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = vg(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del grads
        return walls

    auto = walls_of(api.value_and_grad_offloaded(
        model.train_loss, runner="fused", device="cuda"))
    tune = api.last_tune()
    sched = f"I={args.interval} s={args.slots}"
    vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                      interval=args.interval,
                                      slots=args.slots, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = walls_of(vg)
    peak = torch.cuda.max_memory_allocated() - held
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=args.body_only) as prof:
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ours = hand_written(src)
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and not e.key.startswith(RANGES):
            rows.append((us, e.count, kind(e.key, ours), e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    split = {}
    for us, _, k, _ in rows:
        split[k] = split.get(k, 0.0) + us / 1e3
    tag = f"[profile {args.arch}]"
    head = (f"{tag} {label}: {card}; fused autotuned (I={tune.interval} "
            f"s={tune.slots}) walls {auto[0]:.3f}s (first), {auto[1]:.3f}s "
            f"(warm); fused {sched}, loss {float(loss):.6f}; warm walls "
            f"{walls[0]:.3f}s {walls[1]:.3f}s, profiled {wall:.3f}s; device "
            f"peak above the call's start {peak:,} B; device busy "
            f"{busy:.3f} ms")
    print(head, flush=True)
    if not rows:
        print(f"{tag} {label}: the profiler saw no device time (not "
              "measured)", flush=True)
        return 0
    print(f"{tag} {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
        flush=True)
    S = batch["tokens"].shape[1] - 1
    readout = 4 * -(-S // min(cfg.ce_chunk, S))
    library = sum(n for _, n, k, _ in rows if k == "cuBLAS")
    # a split-K product is a GEMM launch and a reduction launch
    splits = sum(n for _, n, k, key in rows
                 if k == "cuBLAS" and "splitkreduce" in key.lower())
    products = library - splits
    print(f"{tag} {label}: cuBLAS launches {library} ({splits} split-K "
          f"reductions), products {products}; the readout's products "
          f"{readout} (4 a chunk of {min(cfg.ce_chunk, S)} of S={S}); "
          + ", ".join(f"{key[:60]} x{n}" for _, n, k, key in rows
                      if k == "cuBLAS"), flush=True)
    for us, count, k, key in rows[:12]:
        print(f"{tag}   {us / 1e3:10.3f} ms x{count:<6d} {k:12s} "
              f"{key[:80]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f"# {head}\n# device_us\tcount\tkind\tname\n")
            for us, count, k, key in rows:
                f.write(f"{us:.1f}\t{count}\t{k}\t{key}\n")
    rc = 0
    if args.readout_only and products != readout:
        print(f"{tag} {label}: {products} cuBLAS products, the readout "
              f"makes {readout}: the chain body still runs a cuBLAS "
              "product", file=sys.stderr, flush=True)
        rc = 1
    if args.body_only and body_report(prof, ours, args, tag, label,
                                      batch["tokens"].shape[0], S):
        rc = 1
    return rc


def body_report(prof, ours, args, tag, label, B, S) -> bool:
    """Print the device time by body range and the PyTorch kernels inside
    the ranges (to ``--out`` too); True if one of them reads a tensor with
    a token axis."""
    base = os.path.abspath(args.out) if args.out else os.path.join(
        ROOT, "build", "profile_fused")
    trace = os.path.splitext(base)[0] + ".trace.json"
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    try:
        by_range, pytorch = body_split(trace, ours, B, S)
    finally:
        os.remove(trace)
    if not any(r in by_range for r in BODY):
        print(f"{tag} {label}: the trace holds no body range (a tree "
              "without them): body split not measured", flush=True)
        return True
    lines = []
    for rng in BODY + ("outside",):
        split = by_range.get(rng, {})
        lines.append(f"{tag} {label}: range {rng}: {sum(split.values()):.3f}"
                     " ms (" + ", ".join(
                         f"{k} {v:.3f}" for k, v in sorted(
                             split.items(), key=lambda kv: -kv[1])) + ")")
    bad = 0
    rows = sorted(pytorch.items(), key=lambda kv: -kv[1][1])
    for (kname, op, shape), (n, ms) in rows:
        tok = token_axis(shape, B, S)
        bad += tok
        lines.append(f"{tag} {label}:   body PyTorch {ms:10.3f} ms x{n:<5d} "
                     f"{op} {list(shape)}{' TOKEN AXIS' if tok else ''} "
                     f"{kname[:70]}")
    lines.append(f"{tag} {label}: body PyTorch kernels "
                 f"{sum(n for n, _ in pytorch.values())} launches, "
                 f"{sum(ms for _, ms in pytorch.values()):.3f} ms; on a "
                 f"tensor with a token axis: {bad} kinds")
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(f"# {line}\n" for line in lines))
    if bad:
        print(f"{tag} {label}: {bad} kinds of PyTorch kernel inside a fused "
              "segment's body touch a tensor with a token axis",
              file=sys.stderr, flush=True)
    return bool(bad)


if __name__ == "__main__":
    sys.exit(main())

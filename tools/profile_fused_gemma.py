#!/usr/bin/env python3
"""Device time of one warm fused gemma2-2b gradient on the card, by kernel.

    python3 tools/profile_fused_gemma.py [--src DIR] [--out FILE]

Runs ``value_and_grad_offloaded(get_model("gemma2-2b").train_loss,
runner="fused", interval=13, slots=4)`` (``chip_smoke.py``'s phase
``dense`` at its pinned schedule: 26 layers at full width, ``train_4k``
with the batch cut to 2, weights from a seeded CUDA generator) with the
``repro_torch`` package found under ``DIR`` (default: this checkout's
``src``; give a ``git archive`` of another commit's tree to compare), twice
to warm up, then once under ``torch.profiler``.  Prints the wall, the
device's busy time and that time split three ways: the hand-written
kernels (every ``__global__`` function of ``DIR/repro_torch/kernels/csrc``),
the cuBLAS products (kernel names with ``gemm``, ``cutlass``, ``xmma`` or
``nvjet``) and the rest (PyTorch's own kernels); writes the table by kernel
to ``FILE``.  Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARY = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_fused_gemma: no CUDA device", file=sys.stderr)
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
    cfg = get_config("gemma2-2b")
    full = SHAPES["train_4k"]
    shape = ShapeSpec(full.name, full.seq_len, 2, full.kind)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = make_batch(cfg, shape, seed=0)
    vg = api.value_and_grad_offloaded(model.train_loss, runner="fused",
                                      interval=13, slots=4, device="cuda")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
        if us > 0 and not e.key.startswith(("fused.", "split.")):
            rows.append((us, e.count, kind(e.key, ours), e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    split = {}
    for us, _, k, _ in rows:
        split[k] = split.get(k, 0.0) + us / 1e3
    head = (f"[profile-gemma] {label}: {card}; gemma2-2b fused I=13 s=4, "
            f"loss {float(loss):.6f}; warm walls {walls[0]:.3f}s "
            f"{walls[1]:.3f}s, profiled {wall:.3f}s; device busy "
            f"{busy:.3f} ms")
    print(head, flush=True)
    if not rows:
        print(f"[profile-gemma] {label}: the profiler saw no device time "
              "(not measured)", flush=True)
        return 0
    print(f"[profile-gemma] {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
        flush=True)
    for us, count, k, key in rows[:12]:
        print(f"[profile-gemma]   {us / 1e3:10.3f} ms x{count:<6d} {k:12s} "
              f"{key[:80]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f"# {head}\n# device_us\tcount\tkind\tname\n")
            for us, count, k, key in rows:
                f.write(f"{us:.1f}\t{count}\t{k}\t{key}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

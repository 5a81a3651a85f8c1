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
and once under ``torch.profiler``.  Prints the walls, the device's busy
time and that time split three ways: the hand-written kernels (every
``__global__`` function of ``DIR/repro_torch/kernels/csrc``), the cuBLAS
products (kernel names with ``gemm``, ``cutlass``, ``xmma`` or ``nvjet``)
and the rest (PyTorch's own kernels); writes the table by kernel to
``FILE``.  Counts the cuBLAS products (its launches less the split-K
reductions that follow a split product) beside the readout's (the loss
head, ``layers.chunked_ce_loss``: each sequence chunk's logits in the
forward and in its checkpoint's recompute, and their two gradient
products); ``--readout-only`` exits 1 unless the two are equal, that is
unless the chain body launches no cuBLAS product.  Needs one CUDA card;
imports no JAX.
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
    walls = walls_of(vg)
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
    tag = f"[profile {args.arch}]"
    head = (f"{tag} {label}: {card}; fused autotuned (I={tune.interval} "
            f"s={tune.slots}) walls {auto[0]:.3f}s (first), {auto[1]:.3f}s "
            f"(warm); fused {sched}, loss {float(loss):.6f}; warm walls "
            f"{walls[0]:.3f}s {walls[1]:.3f}s, profiled {wall:.3f}s; device "
            f"busy {busy:.3f} ms")
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
    if args.readout_only and products != readout:
        print(f"{tag} {label}: {products} cuBLAS products, the readout "
              f"makes {readout}: the chain body still runs a cuBLAS "
              "product", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

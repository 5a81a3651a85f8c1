#!/usr/bin/env python3
"""Time variants of the projection GEMM (``csrc/dense.cu``) on the card.

    python3 tools/dense_variants.py [NAME=KEY:VALUE,... ...] [--source FILE]

Each variant is ``csrc/dense.cu`` (or ``--source FILE`` for all of them)
with some of its tile constants replaced (``TP``, ``TQ``, ``TR``, ``NS``,
``WP``, ``WQ``; e.g. ``p256=TP:256,TR:64,NS:2``); ``base`` (the source as
it is) always runs first.  Every variant is built with ``nvcc`` (the flags
of ``kernels/build.py``, all at once, into ``build/dense_variants/``), its
registers printed from the ptxas report, and its forward, dx and dw (x, dy
bf16, w fp32; the forward also with a bf16 w) timed with CUDA events
behind a busy wait (``chip_smoke.cuda_ms``) at gemma2-2b's ``wq`` and
``gate`` and mamba2-370m's ``in_proj`` and ``out_proj`` shapes, beside
cuBLAS's ``x @ w_bf16``, ``dy @ w_bf16.T`` and ``x.T @ dy``.  A variant
whose outputs are not bit for bit ``base``'s is marked: the sum's order
is fixed by the 16-deep steps, whatever the tiles.  Needs one CUDA card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
SHAPES = (("gemma2-2b wq", (8192, 2304, 2048)),
          ("gemma2-2b gate", (8192, 2304, 9216)),
          ("mamba2-370m in_proj", (16384, 1024, 4384)),
          ("mamba2-370m out_proj", (16384, 2048, 1024)))
KEYS = ("TP", "TQ", "TR", "NS", "WP", "WQ")


def variant_source(text: str, subs: dict) -> str:
    for key, value in subs.items():
        if key not in KEYS:
            raise SystemExit(f"unknown constant {key}; one of {KEYS}")
        text, n = re.subn(rf"constexpr int {key} = \d+;",
                          f"constexpr int {key} = {int(value)};", text)
        if n != 1:
            raise SystemExit(f"constant {key} not found in the source")
    return text


def build_variant(name, text, out):
    from repro_torch.kernels import build

    cu = os.path.join(out, f"dense_{name}.cu")
    so = os.path.join(out, f"libdense_{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", so, cu], capture_output=True,
                         text=True, timeout=600)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
    lib = ctypes.CDLL(so)
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    for fn in ("dense_fwd", "dense_dx"):
        getattr(lib, fn).restype = I
        getattr(lib, fn).argtypes = [P, L, P, P] + [I] * 5 + [P]
    lib.dense_dw.restype = I
    lib.dense_dw.argtypes = [P, L, P, L, P] + [I] * 5 + [P]
    return lib, re.findall(r"Used (\d+) registers", log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="NAME=KEY:VALUE,...")
    ap.add_argument("--source", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dense_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    text = open(args.source or build.CSRC / "dense.cu").read()
    variants = {"base": {}}
    for spec in args.variants:
        name, _, body = spec.partition("=")
        variants[name] = dict(kv.split(":") for kv in body.split(",") if kv)
    out = os.path.join(ROOT, "build", "dense_variants")
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[dense_variants] {card}", flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda kv: build_variant(kv[0], variant_source(text, kv[1]),
                                     out), variants.items())))
    for name, (_, regs) in built.items():
        print(f"[dense_variants] {name} {variants[name]}: registers "
              f"{', '.join(regs)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    for label, (M, K, N) in SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        dy = torch.randn((M, N), generator=gen, device="cuda").to(bf16)
        wb = w.to(bf16)
        y = torch.empty((M, N), dtype=bf16, device="cuda")
        dx = torch.empty((M, K), dtype=bf16, device="cuda")
        dw = torch.empty((K, N), device="cuda")
        flops = 2.0 * M * K * N
        s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def ptr(t):
            return ctypes.c_void_p(t.data_ptr())

        lib_ms = [cs.cuda_ms(fn, 20) for fn in (lambda: x @ wb,
                                                lambda: dy @ wb.T,
                                                lambda: x.T @ dy)]
        print(f"[dense_variants] {label} (M={M}, K={K}, N={N}) cuBLAS ms: "
              f"{lib_ms[0]:.4f} / {lib_ms[1]:.4f} / {lib_ms[2]:.4f}",
              flush=True)
        ref = None
        for name, (lib, _) in built.items():
            calls = (
                lambda: lib.dense_fwd(ptr(x), K, ptr(w), ptr(y), M, K, N, 1,
                                      0, s),
                lambda: lib.dense_dx(ptr(dy), N, ptr(w), ptr(dx), M, K, N, 1,
                                     0, s),
                lambda: lib.dense_dw(ptr(x), K, ptr(dy), N, ptr(dw), M, K, N,
                                     1, 0, s),
                lambda: lib.dense_fwd(ptr(x), K, ptr(wb), ptr(y), M, K, N, 1,
                                      1, s))
            for fn in calls[:3]:
                cs.require(fn() == 0, f"{name}: launch failed")
            torch.cuda.synchronize()
            got = (y.clone(), dx.clone(), dw.clone())
            ref = ref or got
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            ms = [cs.cuda_ms(fn, 20) for fn in calls]
            print(f"[dense_variants] {label} {name}: forward {ms[0]:.4f} ms, "
                  f"dx {ms[1]:.4f}, dw {ms[2]:.4f}, forward with a bf16 w "
                  f"{ms[3]:.4f} (TFLOP/s "
                  + " / ".join(f"{flops / m / 1e9:.0f}" for m in ms) + ")"
                  + ("" if same else "; NOT bit for bit base's"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

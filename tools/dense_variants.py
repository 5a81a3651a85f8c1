#!/usr/bin/env python3
"""Time variants of the projection GEMM (``csrc/dense.cu``) on the card.

    python3 tools/dense_variants.py [NAME=KEY:VALUE,... ...] [--source FILE]

Each variant is ``csrc/dense.cu`` (or ``--source FILE`` for all of them)
with some of the Hopper form's constants replaced: ``GQ`` (the output
tile's columns, one wgmma's N: 64, 128 or 256), ``GS`` (stages in the
ring; the ring of 128 x 64 and 64 x GQ bf16 slabs must fit the 227 KB of
shared memory a block can use) and ``GROUP`` (rows of tiles a group of
the persistent walk); e.g. ``q128s6=GQ:128,GS:6``.  ``base`` (the source
as it is) always runs first.  Every variant is built with ``nvcc`` (the
flags of ``kernels/build.py``, all at once, into
``build/dense_variants/``), its registers printed from the ptxas report,
and its forward, dx and dw (x, dy bf16, w fp32: the forward and dx with
the weight's per-call bf16 copy, dw with its split over M where the tiles
do not fill the card; the forward also with a bf16 w) timed through the
``kernels/dense.py`` wrappers with CUDA events behind a busy wait
(``chip_smoke.cuda_ms``) at gemma2-2b's ``wq`` and ``gate`` and
mamba2-370m's ``in_proj`` and ``out_proj`` shapes, beside cuBLAS's ``x @
w_bf16``, ``dy @ w_bf16.T`` and ``x.T @ dy``.  A variant whose outputs are
not bit for bit ``base``'s is marked: the sum's order is fixed by the
16-deep steps, whatever the tiles.  Needs one CUDA card; imports no JAX.
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
KEYS = ("GQ", "GS", "GROUP")


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
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_error_string.argtypes = [ctypes.c_int]
    return lib, re.findall(r"Used (\d+) registers", log)


def through(lib, fn):
    """``fn()`` with ``kernels/dense.py``'s wrappers launching ``lib``."""
    from repro_torch.kernels import build

    real = build.load
    build.load = lambda name: lib if name == "dense" else real(name)
    try:
        return fn()
    finally:
        build.load = real


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
    from repro_torch.kernels import dense as dn

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
        flops = 2.0 * M * K * N
        lib_ms = [cs.cuda_ms(fn, 20) for fn in (lambda: x @ wb,
                                                lambda: dy @ wb.T,
                                                lambda: x.T @ dy)]
        print(f"[dense_variants] {label} (M={M}, K={K}, N={N}) cuBLAS ms: "
              f"{lib_ms[0]:.4f} / {lib_ms[1]:.4f} / {lib_ms[2]:.4f}",
              flush=True)
        ref = None
        for name, (lib, _) in built.items():
            calls = (lambda: dn.dense_fwd(x, w),
                     lambda: dn.dense_bwd(dy, x, w, need_dw=False),
                     lambda: dn.dense_bwd(dy, x, w, need_dx=False),
                     lambda: dn.dense_fwd(x, wb))
            got = through(lib, lambda: (calls[0](), *calls[1](),
                                        *calls[2]()))
            torch.cuda.synchronize()
            got = tuple(t for t in got if t is not None)
            ref = ref or got
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            ms = [through(lib, lambda: cs.cuda_ms(fn, 20)) for fn in calls]
            print(f"[dense_variants] {label} {name}: forward {ms[0]:.4f} ms, "
                  f"dx {ms[1]:.4f}, dw {ms[2]:.4f}, forward with a bf16 w "
                  f"{ms[3]:.4f} (TFLOP/s "
                  + " / ".join(f"{flops / m / 1e9:.0f}" for m in ms) + ")"
                  + ("" if same else "; NOT bit for bit base's"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

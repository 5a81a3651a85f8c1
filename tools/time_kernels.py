#!/usr/bin/env python3
"""Time hand-written kernels on the card by name, beside a parent tree's
forms and variants of their sources' constants in the same call.

    python3 tools/time_kernels.py
        --kernels flash,rmsnorm,ssd_scan_bwd,entry_store
        [--parent DIR] [--out-dir DIR]
        [--variants KERNEL:NAME=KEY:VALUE,... ...]

Builds the named kernels' libraries from this checkout (and, with
``--parent``, from the checkout in DIR, a ``git archive`` of another
commit) with ``nvcc``, then runs ``chip_smoke.py``'s timings of them, each
new form in turns with the parent's, CUDA events behind a busy wait:

* ``flash``: ``_time_flash`` at gemma2-2b's and phi3.5-moe's attention
  layers (B=2, S=4096; beside SDPA, the bound and the TFLOP/s);
* ``rmsnorm``: ``_time_rmsnorm`` at gemma2-2b's rows (the forward, with the
  residual, the backward with one, two and three consumers' cotangents;
  beside ``F.rms_norm`` and its gradient; the forward and the fan-out
  backward also at phi3.5-moe's width), and its kernels' device times by
  ``torch.profiler``;
* ``ssd_scan_bwd``: ``time_ssd_bwd`` at mamba2-370m's layer (B=4, T=4096,
  bf16), its device time by pass and its target;
* ``entry_store``: ``_time_entry_store`` at gemma2-2b's and mamba2-370m's
  carries, beside its plain version and the copy engine.

Prints the card's name and power limit first, and each library's SASS
counts (HGMMA, the warpgroup waits ptxas placed, barriers, exponentials,
16-byte accesses, bulk copies) for its Hopper kernels.  Each ``--variants``
entry is a kernel's source with some of its constants replaced (``KEYS``;
e.g. ``entry_store:b8=STORE_BLOCKS:8,STAGE_BYTES:32768`` or
``rmsnorm:b512=BWD_BLOCKS:512,BWD_MIN_ROWS:8``), built beside it, its
registers and spills printed from its ptxas report, and timed after it by
the same function.  Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# kernel -> its library
LIBS = {"flash": "flash_attention", "rmsnorm": "rmsnorm",
        "ssd_scan_bwd": "ssd_scan_bwd", "entry_store": "segment_generic"}
# the constants a variant may replace, by library
KEYS = {"rmsnorm": ("BWD_BLOCKS", "BWD_MIN_ROWS"),
        "flash_attention": ("PIPE_MAX_D", "FWD_BK", "FWD_BK_256",
                            "FWD_STAGES_128"),
        "ssd_scan_bwd": ("LOW_PARTS",),
        "segment_generic": ("STORE_BLOCKS", "STAGE_BYTES", "STAGES",
                            "AHEAD")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(LIBS),
                    help="comma-separated, of " + ",".join(LIBS))
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit to time beside")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "time_kernels"))
    ap.add_argument("--variants", nargs="*", default=[],
                    help="KERNEL:NAME=KEY:VALUE,... variants of a source")
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = set(kernels) - set(LIBS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; of {sorted(LIBS)}")
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    state = {"out_dir": os.path.abspath(args.out_dir)}
    os.makedirs(state["out_dir"], exist_ok=True)
    cs.phase_device(state)
    names = [LIBS[k] for k in kernels]
    secs = build.build_all(names)
    cs.log("[build] " + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    if args.parent:
        state["parent_libs"] = cs.build_parent(
            os.path.abspath(args.parent), state["out_dir"], names)
    for kernel in kernels:
        TIMERS[kernel](torch, state, "base")
        sass_counts(str(build.library_path(LIBS[kernel])),
                    f"{LIBS[kernel]} base")
    state.pop("parent_libs", None)
    by_kernel = {}
    for spec in args.variants:
        kernel, _, rest = spec.partition(":")
        if kernel not in kernels:
            ap.error(f"variant {spec}: kernel {kernel} is not among "
                     f"--kernels")
        by_kernel.setdefault(kernel, []).append(rest)
    for kernel, specs in by_kernel.items():
        lib_name = LIBS[kernel]
        for name, lib in build_variants(lib_name, specs,
                                        state["out_dir"]).items():
            cs.log(f"[variant] {kernel} {name}")
            with cs._library(lib_name, lib):
                TIMERS[kernel](torch, state, name)
    return 0


def time_flash(torch, state, label):
    import chip_smoke as cs
    from repro_torch.configs import get_config

    for arch in ("gemma2-2b", "phi3.5-moe-42b"):
        cs._time_flash(torch, {"cfg": get_config(arch), "B": 2, "S": 4096},
                       state)


def time_rmsnorm(torch, state, label):
    import chip_smoke as cs

    cs._time_rmsnorm(torch, state)
    profile_rmsnorm(torch, label)


def time_ssd_bwd(torch, state, label):
    import chip_smoke as cs
    import numpy as np

    args = list(cs._ssd_bwd_args(torch, np.random.default_rng(73),
                                 cs.MAMBA_SSD, "bfloat16", False))
    args[7] = torch.zeros_like(args[7])   # the model's zero final cotangent
    cs.time_ssd_bwd(torch, args, cs.MAMBA_SSD[-1], state)
    del args
    torch.cuda.empty_cache()


def time_entry_store(torch, state, label):
    import chip_smoke as cs

    for arch in cs.CARRIES:
        cs._time_entry_store(torch, arch, state)


TIMERS = {"flash": time_flash, "rmsnorm": time_rmsnorm,
          "ssd_scan_bwd": time_ssd_bwd, "entry_store": time_entry_store}

SASS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "BAR.SYNC",
        "BAR.ARV", "MUFU.EX2", "LDG.E.128", "STG.E.128", "UBLKCP",
        "SYNCS")


def sass_counts(so, label):
    """Counts of some instructions in each Hopper kernel of a built library
    (``cuobjdump -sass``), logged: the products, the waits ptxas put
    around them, the barriers, the exponentials, the 16-byte accesses, the
    bulk copies and their barriers."""
    import re
    import shutil
    import subprocess

    import chip_smoke as cs

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=300).stdout
    name, counts = None, {}
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(SASS, 0)
        elif name is not None:
            for inst in SASS:
                if re.search(rf"\b{re.escape(inst)}\b", line):
                    counts[name][inst] += 1
    for name, c in counts.items():
        if any(k in name for k in ("wgmma", "hop_", "entry_store")) or (
                "bwd_vec" in name and "Li9E" in name):
            cs.log(f"[sass] {label} {name[:60]}: " + ", ".join(
                f"{k} {v}" for k, v in c.items() if v))


def profile_rmsnorm(torch, label):
    """Device time by kernel of one rmsnorm forward and backward (one
    cotangent; three and the skip's) at gemma2-2b's rows, from
    ``torch.profiler``, logged."""
    import chip_smoke as cs
    import numpy as np
    from repro_torch.kernels import rmsnorm as rn

    rng = np.random.default_rng(3)
    x, g, g2, g3, sk = (cs._randn(torch, rng, (2, 4096, 2304),
                                  torch.bfloat16) for _ in range(5))
    scale = cs._randn(torch, rng, (2304,), torch.float32, 0.3)
    _, rstd = rn.rmsnorm(x, scale)
    calls = (("fwd", lambda: rn.rmsnorm(x, scale)),
             ("bwd1", lambda: rn.rmsnorm_bwd(g, x, scale, rstd)),
             ("bwd3", lambda: rn.rmsnorm_bwd(g, x, scale, rstd,
                                             g_more=(g2, g3), dskip=sk)))
    for what, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev = getattr(ev, "device_time_total", None) or getattr(
                ev, "cuda_time_total", 0.0)
            if dev and ev.count:
                cs.log(f"[profile] rmsnorm {label} {what}: {ev.key[:60]} "
                       f"{dev / ev.count / 1e3:.4f} ms x {ev.count}")


def build_variants(lib, specs, out):
    """``{name: ctypes.CDLL}`` for each ``NAME=KEY:VALUE,...`` variant of
    library ``lib``'s source, built with ``nvcc`` all at once; the Hopper
    kernels' registers and spills and SASS counts logged."""
    import ctypes
    import re
    import subprocess

    import chip_smoke as cs
    from repro_torch.kernels import build

    procs = {}
    keys = KEYS[lib]
    for spec in specs:
        name, _, subs = spec.partition("=")
        text = (build.CSRC / build.SOURCES[lib]).read_text()
        for sub in filter(None, subs.split(",")):
            key, _, value = sub.partition(":")
            if key not in keys:
                raise SystemExit(f"unknown constant {key}; one of {keys}")
            text, n = re.subn(rf"constexpr (int|long) {key} = \d+;",
                              rf"constexpr \1 {key} = {int(value)};", text)
            if n != 1:
                raise SystemExit(f"constant {key} not found")
        cu = os.path.join(out, f"{lib}_{name}.cu")
        so = os.path.join(out, f"lib{lib}_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log[-3000:]}")
        for line in log.splitlines():
            if "Performance" in line or "serialized" in line:
                cs.log(f"[variant] {lib} {name}: ptxas: {line.strip()}")
        for kern, regs, spill in cs.ptxas_usage(log):
            if any(k in kern for k in ("wgmma", "hop_", "entry_store")) or \
                    "bwd_vec_kernel<__nv_bfloat16, __nv_bfloat16, (int)9>" \
                    in kern:
                cs.log(f"[variant] {lib} {name}: {kern.split('(')[0]}: "
                       f"{regs} registers, {spill}")
        sass_counts(so, f"{lib} {name}")
        libs[name] = ctypes.CDLL(so)
    return libs


if __name__ == "__main__":
    sys.exit(main())

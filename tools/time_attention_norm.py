#!/usr/bin/env python3
"""Time the attention forward and rmsnorm on the card, beside a parent
tree's forms in the same call.

    python3 tools/time_attention_norm.py [--parent DIR] [--out-dir DIR]
        [--rmsnorm-variants NAME=KEY:VALUE,... ...]
        [--flash-variants NAME=KEY:VALUE,... ...]

Builds ``flash_attention`` and ``rmsnorm`` from this checkout (and, with
``--parent``, from the checkout in DIR, a ``git archive`` of another
commit) with ``nvcc``, then runs ``chip_smoke.py``'s timings of them:
``_time_flash`` at gemma2-2b's and phi3.5-moe's attention layers (B=2,
S=4096; beside SDPA, the bound and the TFLOP/s) and ``_time_rmsnorm`` at
gemma2-2b's rows (the forward, with the residual, the backward with one,
two and three consumers' cotangents; beside ``F.rms_norm`` and its
gradient; the forward and the fan-out backward also at phi3.5-moe's
width), each new form in turns with the parent's (parent, this tree,
parent), CUDA events behind a busy wait; rmsnorm's kernels' device times by
``torch.profiler`` and the Hopper kernels' SASS counts (HGMMA, the
warpgroup waits ptxas placed, barriers, exponentials) after.  Prints the
card's name and power limit first.  Each ``--rmsnorm-variants`` entry is
``csrc/rmsnorm.cu`` with some of its constants replaced (``BWD_BLOCKS``,
``BWD_MIN_ROWS``; e.g. ``b512=BWD_BLOCKS:512,BWD_MIN_ROWS:8``), built
beside it and timed after it by the same ``_time_rmsnorm``;
``--flash-variants`` likewise for ``csrc/flash_attention.cu``
(``PIPE_MAX_D``, ``FWD_BK``, ``FWD_BK_256``, ``FWD_STAGES_128``) and
``_time_flash``, each variant's registers and spills printed from its
ptxas report.  The short measurement of phase ``timing``'s rows for these
two kernels; needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit to time beside")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "time_attention_norm"))
    ap.add_argument("--rmsnorm-variants", nargs="*", default=[],
                    help="NAME=KEY:VALUE,... variants of rmsnorm.cu")
    ap.add_argument("--flash-variants", nargs="*", default=[],
                    help="NAME=KEY:VALUE,... variants of flash_attention.cu")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_attention_norm: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    state = {"out_dir": os.path.abspath(args.out_dir)}
    os.makedirs(state["out_dir"], exist_ok=True)
    cs.phase_device(state)
    names = ("flash_attention", "rmsnorm")
    secs = build.build_all(names)
    cs.log("[build] " + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    if args.parent:
        state["parent_libs"] = cs.build_parent(
            os.path.abspath(args.parent), state["out_dir"], names)
    for arch in ("gemma2-2b", "phi3.5-moe-42b"):
        cs._time_flash(torch, {"cfg": get_config(arch), "B": 2, "S": 4096},
                       state)
    cs._time_rmsnorm(torch, state)
    profile_rmsnorm(torch, "base")
    sass_counts(str(build.library_path("flash_attention")),
                "flash_attention base")
    state.pop("parent_libs", None)
    variants = {lib: build_variants(lib, specs, state["out_dir"])
                for lib, specs in (("rmsnorm", args.rmsnorm_variants),
                                   ("flash_attention", args.flash_variants))}
    for lib_name, libs in variants.items():
        for name, lib in libs.items():
            cs.log(f"[variant] {lib_name} {name}")
            load = build.load
            build.load = lambda n, _v=lib, _n=lib_name: (
                _v if n == _n else load(n))
            try:
                if lib_name == "rmsnorm":
                    cs._time_rmsnorm(torch, state)
                    profile_rmsnorm(torch, name)
                else:
                    for arch in ("gemma2-2b", "phi3.5-moe-42b"):
                        cs._time_flash(torch, {"cfg": get_config(arch),
                                               "B": 2, "S": 4096}, state)
            finally:
                build.load = load
    return 0


SASS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "BAR.SYNC",
        "BAR.ARV", "MUFU.EX2", "LDG.E.128", "STG.E.128")


def sass_counts(so, label):
    """Counts of some instructions in each Hopper kernel of a built library
    (``cuobjdump -sass``), logged: the products, the waits ptxas put
    around them, the barriers, the exponentials, the 16-byte accesses."""
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
        if "wgmma" in name or ("bwd_vec" in name and "Li9E" in name):
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


KEYS = {"rmsnorm": ("BWD_BLOCKS", "BWD_MIN_ROWS"),
        "flash_attention": ("PIPE_MAX_D", "FWD_BK", "FWD_BK_256",
                            "FWD_STAGES_128")}


def build_variants(lib, specs, out):
    """``{name: ctypes.CDLL}`` for each ``NAME=KEY:VALUE,...`` variant of
    library ``lib``'s source, built with ``nvcc`` all at once; the Hopper
    kernels' registers and spills logged."""
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
            if "wgmma" in kern or "bwd_vec_kernel<__nv_bfloat16, " \
                    "__nv_bfloat16, (int)9>" in kern:
                cs.log(f"[variant] {lib} {name}: {kern.split('(')[0]}: "
                       f"{regs} registers, {spill}")
        sass_counts(so, f"{lib} {name}")
        libs[name] = ctypes.CDLL(so)
    return libs


if __name__ == "__main__":
    sys.exit(main())

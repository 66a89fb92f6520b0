#!/usr/bin/env python3
"""Drive the PyTorch port's text-to-image main path on one CUDA card.

    python3 chip_smoke.py            # the default phases, on one card

Phases (each one's failure fails the run; nothing falls back to the CPU):
  device    require CUDA; print the card's name and power limit
  build     compile every CUDA source (one nvcc each, in parallel) and the
            Triton kernels; print the seconds
  kernels   each kernel against its plain version at the main paths'
            shapes: max error, kernel / plain / library-call ms and the
            bound (bytes or operations over the card's peak). "ms" is device
            time (calls captured in a CUDA graph, replayed between CUDA
            events); the "eager" times are the same calls launched one by
            one, host launch costs included
  main      vd_four_flow_v1-0 at full width in bf16, seeded random weights,
            inference_t2i at 512^2, n = 2, DDIM-50, CFG 7.5, cold then warm;
            the launch counters are zeroed just before each run and read
            just after it
  eps       one full-width UNet eps call on the card (bf16) against the port
            on the CPU in f32, same weights and inputs
  main_int8 the calibrated int8 serving policy on the same system:
            enable_int8 (calibration, timed); the int8 conv kernel against
            its plain version at every distinct conv site of one UNet call,
            on that site's own arguments; then the same request cold and
            warm as (a) int8 and (b) int8 + ToMe 0.75, each with its launch
            counts of the no-max (also by kv length: ToMe's merged sites),
            int8 conv and torch._int_mm paths
  modes     one full-width int8 eps call in each opt-in policy mode
            (gn_prologue "fused" and "stats", conv "fused") against the
            default mode's, with each mode's launch counts derived from the
            program, and the fused-prologue conv against its plain version
            at every distinct site of its call
  eps_int8  one full-width int8 eps call on the card (bf16) against the
            port's int8 plain path on the CPU in f32, same scales
  train     t2i training at full width: frees the serving system, builds
            vd_four_flow_v1-0 with f32 parameters (bf16 compute, no remat),
            encodes 8 stand-in prompts, holds one micro-batch-2 gradient of
            the trainable tree through the kernels against the same
            gradient through the plain versions, then runs Trainer steps
            (global batch 8 at 512^2, grad_accum 2, AdamW with the t2i
            experiment's groups, EMA 0.9999), each with its launch counts;
            one more step under torch.profiler
  profile   (not run by default) the warm request split into its stages,
            and one CFG UNet step under torch.profiler: device busy and
            idle share, kernel time by kind and the top kernels

It prints the card line and a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. ``--phases`` runs a subset (development
only; the summary lines then cover what ran). Outputs too long for the end
of the log go to ``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import zlib

PHASES = ("device", "build", "kernels", "main", "eps", "main_int8", "modes", "eps_int8",
          "train", "profile")
DEFAULT_PHASES = PHASES[:-1]

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# and the special-function units' exponentials: 16 per SM per clock on 132
# SMs at the 1.98 GHz boost clock.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_EXP = 16 * 132 * 1.98e9

FLASH_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# no-max attention: int8 exact (4096 and 1024 tokens) and the ToMe 0.75
# site (4096 tokens merged to 1024 at d_head 40)
NOMAX_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 40), (4, 1024, 8, 80)]
# int8 3x3 conv: (B, C_in, H, W, C_out, stride, add); the first is the
# commonest site (64^2 ResBlock conv with its FiLM vector)
QCONV_SHAPES = [(4, 320, 64, 64, 320, 1, "film"), (4, 4, 64, 64, 320, 1, None),
                (4, 960, 64, 64, 320, 1, "res"), (4, 320, 64, 64, 320, 2, None),
                (4, 1280, 16, 16, 1280, 1, "film")]
GN_SHAPES = [(4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 16, 16), (4, 2560, 8, 8),
             (2, 128, 512, 512)]
# |kernel - plain| <= ATOL + RTOL * |plain|: two bf16 ulps at the output's
# magnitude; both sides read the same bf16 inputs and differ only in the
# order of f32 sums and where the output is rounded
ATOL, RTOL = 1e-2, 1.6e-2
# eps call, bf16 on the card vs f32 on the CPU through the full-width UNet
EPS_MIN_COS, EPS_MAX_REL_L2 = 0.995, 0.05
# Two int8 runs that round some activation at another point (bf16 against
# f32 activations; an opt-in policy mode quantizing the f32 GN+SiLU output
# where the default mode quantizes its bf16 rounding) flip a share of the
# codes at every site, and the flips feed the next sites: after a few sites
# the two quantization noises are independent. So these whole-UNet gates
# are sanity bounds, fixed from the H100 readings (modes: relative L2
# 0.05116-0.06945, cosine >= 0.997593; eps_int8: 0.06766, 0.997711;
# int8's own error against the exact bf16 eps 0.064), about 1.45x above
# the largest. What holds the kernels to their plain versions at every
# int8 site of the request is the site check of main_int8 and modes; what
# shows each mode's routing is its exact launch counts.
INT8_MAX_REL_L2, INT8_MIN_COS = 0.10, 0.995
# GN+SiLU+int8 against its plain version: a code may differ by one where
# y / s lies within f32 rounding of a half-integer (other summation order
# of the statistics, y / (1 + exp(-y)) against y * sigmoid(y))
GNQ_MAX_OFF_BY_ONE = 1e-3
# flash backward against its plain version: the gradients are small (about
# 1e-2 at the path's shapes), so the two bf16 ulps are taken at the largest
# magnitude of each output, |k - p| <= ATOL * max|p| + RTOL * |p|, and the
# relative L2 error must stay under 1e-2; lse (f32) within 1e-3
BWD_MAX_REL_L2, LSE_ATOL = 1e-2, 1e-3
# training: one micro-batch-2 gradient of the trainable tree through the
# kernels against the plain versions on the card, fixed before the first run
TRAIN_MIN_COS, TRAIN_MAX_REL_L2 = 0.995, 0.05
TRAIN_STEPS = 4          # Trainer steps; the first is cold
TRAIN_BATCH, TRAIN_ACCUM = 8, 2
TRAIN_FREEZE = ("diffuser_text_data",)
# vdtpu/config/experiments/vd_laion_t2i.yaml
TRAIN_PG_LRSCALE = {"diffuser_image_data": 1.0, "diffuser_image_context": 1.0,
                    "diffuser_text_data": 0.5, "diffuser_text_context": 0.5}
TOME_RATIO = 0.75
SEED = 0      # weights, noise and inputs are made from it
STEPS = 50    # DDIM steps of the main-path request

_LOG = None


def log(*parts):
    msg = " ".join(str(p) for p in parts)
    print(msg, flush=True)
    if _LOG is not None:
        _LOG.write(msg + "\n")
        _LOG.flush()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
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


def time_graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so host launch costs
    (Python, Triton's launcher) drop out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def compare(out, ref):
    """(max abs err, relative L2 err, within tolerance) of two tensors, in f32."""
    import torch
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool((err <= ATOL + RTOL * b.abs()).all())
    return float(err.max()), float(err.norm() / b.norm()), ok


def stand_in_tokenizer(texts, max_length: int = 77):
    """Deterministic CLIP-shaped ids (no vocabulary ships with the repo):
    BOS 49406, one crc32 id per word, EOT 49407 padding to 77."""
    import numpy as np
    rows = []
    for t in texts:
        ids = [1 + zlib.crc32(w.encode()) % 49400 for w in t.split()][: max_length - 2]
        rows.append([49406] + ids + [49407] * (max_length - 1 - len(ids)))
    return np.array(rows, np.int64)


def phase_device(state):
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    state["card"] = smi.stdout.strip().splitlines()[0]
    log(f"card: {state['card']}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")


def phase_build(state):
    import torch
    from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_q, gn_stats
    from vdtpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in build.build_logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) > 0 for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  nvcc {name}: {len(regs)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, {spills} with spills")
    x = torch.randn(2, 64, 4, 4, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    for silu in (True, False):  # compile the Triton specializations
        gn_silu(x, w, w, 32, 1e-5, silu)
    gn_silu_q(x, w, w, torch.ones((), device="cuda"), 32, 1e-5, True)
    gn_stats(x, 32, 1e-5)
    torch.cuda.synchronize()
    state["build_s"] = time.perf_counter() - t0
    log(f"build: nvcc {t_nvcc:.2f} s, with triton {state['build_s']:.2f} s")


def _attention_case(shape, gen, nomax: bool = False):
    """The flash kernel, or the no-max kernel with the true per-head max
    logit as its shift, against its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    b, n, h, d = shape
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    if nomax:
        shift = _true_shift(q, k, d ** -0.5)
        kern = lambda: flash_attention_nomax(q, k, v, shift)
        plain = lambda: flash_attention_nomax_plain(q, k, v, shift)
    else:
        kern = lambda: flash_attention(q, k, v)
        plain = lambda: flash_attention_plain(q, k, v)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref)
    extra = {}
    if not nomax:  # the lse output (training's forward) and its time
        from vdtpu_torch.ops.flash import flash_attention_fwd
        kern_lse = lambda: flash_attention_fwd(q, k, v, d ** -0.5, with_lse=True)
        (out_l, lse), (_, lse_ref) = kern_lse(), flash_attention_plain(q, k, v, with_lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        ok = ok and compare(out_l, ref)[2] and lse_err <= LSE_ATOL
        extra = dict(lse_max_abs_err=lse_err, ms_with_lse=time_graph_ms(kern_lse))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=time_ms(lib, 20))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2), time_graph_ms(lib)
    nbytes = 4 * q.numel() * q.element_size()
    flops, exps = 4.0 * b * h * n * n * d, float(b * h * n * n)
    bound_ms, bound_by = _bound(nbytes, max(flops / PEAK_BF16, exps / PEAK_EXP))
    return dict(shape=list(shape), max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library="F.scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by, eager=eager,
                bound_detail=dict(bytes=nbytes, flops=flops, exps=exps), **extra)


def _flash_bwd_case(shape, gen):
    """The backward kernels against the plain backward on the same (q, k, v,
    o, lse, dO), and the backward of SDPA (autograd fwd + bwd minus fwd)."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain)
    b, n, h, d = shape
    scale = d ** -0.5
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    kern = lambda: flash_attention_bwd(q, k, v, o, lse, do, scale)
    plain = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    outs, refs = kern(), plain()
    torch.cuda.synchronize()
    err = rel = 0.0
    ok = True
    for a, r in zip(outs, refs):
        a, r = a.float(), r.float()
        e = (a - r).abs()
        top = float(r.abs().max())
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            (e <= ATOL * top + RTOL * r.abs()).all())
        err, rel = max(err, float(e.max())), max(rel, float(e.norm() / r.norm()))
    ok = ok and rel <= BWD_MAX_REL_L2
    del outs, refs
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    lib_f = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    lib_fb = lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt),
                                         (qt, kt, vt), dot)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1))
    ms, plain_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2)
    lib_ms = time_ms(lib_fb, 20) - time_ms(lib_f, 20)
    prod = 2.0 * b * h * n * n * d             # one q.k^T-sized product
    exps = float(b * h * n * n)
    nbytes = 8 * q.numel() * q.element_size() + lse.numel() * lse.element_size()
    bound_ms, bound_by = _bound(nbytes, max(5 * prod / PEAK_BF16, exps / PEAK_EXP))
    split_ms, _ = _bound(nbytes, max(7 * prod / PEAK_BF16, 2 * exps / PEAK_EXP))
    return dict(shape=list(shape), max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                library="F.scaled_dot_product_attention backward (autograd fwd+bwd minus fwd)",
                bound_ms=bound_ms, bound_by=bound_by, two_kernel_split_bound_ms=split_ms,
                eager=eager, bound_detail=dict(bytes=nbytes, flops=5 * prod, exps=exps))


def _gn_case(shape, gen):
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_plain
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    bias = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    worst = (0.0, 0.0, True)
    for silu in (True, False):
        err, rel, ok = compare(gn_silu(x, w, bias, 32, 1e-6, silu),
                               gn_silu_plain(x, w, bias, 32, 1e-6, silu))
        worst = (max(worst[0], err), max(worst[1], rel), worst[2] and ok)
    iters = 50 if x.numel() < 1 << 24 else 10
    kern = lambda: gn_silu(x, w, bias, 32, 1e-5, True)
    plain = lambda: gn_silu_plain(x, w, bias, 32, 1e-5, True)
    lib = lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-5))
    eager = dict(ms=time_ms(kern, iters), plain_ms=time_ms(plain, iters),
                 library_ms=time_ms(lib, iters))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain), time_graph_ms(lib)
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * w.element_size()
    flops = 12.0 * x.numel()
    bound_ms, bound_by = _bound(nbytes, flops / PEAK_F32)
    return dict(shape=list(shape), max_abs_err=worst[0], rel_l2_err=worst[1], ok=worst[2],
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.group_norm + F.silu (two calls)", bound_ms=bound_ms,
                bound_by=bound_by, eager=eager, bound_detail=dict(bytes=nbytes, flops=flops))


def _bound(nbytes, t_ops):
    """(bound ms, "bytes" or "operations") from the bytes moved and the
    operations' time in seconds."""
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _true_shift(q, k, scale):
    """Per-head max of the scaled logits (the calibrated bound's ideal),
    over blocks of 256 queries."""
    import torch
    mx = torch.full((q.shape[2],), -1e30, device=q.device)
    kf = k.float()
    for q0 in range(0, q.shape[1], 256):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + 256].float(), kf) * scale
        mx = torch.maximum(mx, s.amax(dim=(0, 2, 3)))
    return mx


def _gn_q_case(shape, gen):
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    bias = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    s = torch.tensor(0.02, device="cuda")
    codes = gn_silu_q(x, w, bias, s, 32, 1e-5, True)
    diff = (codes.int() - gn_silu_q_plain(x, w, bias, s, 32, 1e-5, True).int()).abs()
    off = float((diff > 0).float().mean())
    st, st_ref = gn_stats(x, 32, 1e-5), gn_stats_plain(x, 32, 1e-5)
    st_err = float(((st - st_ref).abs() / st_ref.abs().clamp_min(1e-6)).max())
    torch.cuda.synchronize()
    ok = int(diff.max()) <= 1 and off <= GNQ_MAX_OFF_BY_ONE and st_err <= 1e-4

    def lib():  # F.group_norm + F.silu + the quantize ops: several calls
        y = F.silu(F.group_norm(x, 32, w, bias, 1e-5)).float()
        return torch.clamp(torch.round(y * (1.0 / s)), -127, 127).to(torch.int8)

    iters = 50 if x.numel() < 1 << 24 else 10
    kern = lambda: gn_silu_q(x, w, bias, s, 32, 1e-5, True)
    plain = lambda: gn_silu_q_plain(x, w, bias, s, 32, 1e-5, True)
    stats = lambda: gn_stats(x, 32, 1e-5)
    stats_plain = lambda: gn_stats_plain(x, 32, 1e-5)
    # the statistics' yardstick: one library reduction over the groups
    # (mean and biased variance per (b, g), without the channel broadcast)
    stats_lib = lambda: torch.var_mean(x.view(shape[0], 32, -1), dim=-1, correction=0)
    eager = dict(ms=time_ms(kern, iters), plain_ms=time_ms(plain, iters),
                 library_ms=time_ms(lib, iters), stats_ms=time_ms(stats, iters))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain), time_graph_ms(lib)
    stats_ms, stats_plain_ms = time_graph_ms(stats), time_graph_ms(stats_plain)
    stats_lib_ms = time_graph_ms(stats_lib)
    nbytes = x.numel() * (x.element_size() + 1) + 2 * c * w.element_size()
    bound_ms, bound_by = _bound(nbytes, 14.0 * x.numel() / PEAK_F32)
    return dict(shape=list(shape), max_abs_err=float(diff.max()), off_by_one=off,
                stats_rel_err=st_err, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.group_norm + F.silu + round/clamp/cast (several calls)",
                stats_ms=stats_ms, stats_plain_ms=stats_plain_ms, stats_library_ms=stats_lib_ms,
                stats_library="torch.var_mean over the groups (one call)",
                stats_bound_ms=1e3 * x.numel() * x.element_size() / PEAK_BYTES,
                bound_ms=bound_ms, bound_by=bound_by, eager=eager,
                bound_detail=dict(bytes=nbytes, flops=14.0 * x.numel()))


def _qconv_case(spec, gen):
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_stats
    from vdtpu_torch.ops.qconv import qconv3, qconv3_gn, qconv3_gn_plain, qconv3_plain
    b, c, h, w, n, stride, add = spec
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    rnd = lambda *sh: torch.randn(sh, device="cuda", generator=gen)
    x = (rnd(b, c, h, w) * 2 + 0.5).to(torch.bfloat16)
    xq = torch.randint(-127, 128, (b, h, w, c), device="cuda", generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (n, 3, 3, c), device="cuda", generator=gen).to(torch.int8)
    w_scale = torch.rand(n, device="cuda", generator=gen) * 1e-3 + 1e-4
    bias = (rnd(n) * 0.1).to(torch.bfloat16)
    s_x = torch.tensor(0.05, device="cuda")
    gamma, beta = torch.rand(c, device="cuda", generator=gen) + 0.5, rnd(c) * 0.1
    film = rnd(b, n).to(torch.bfloat16) if add == "film" else None
    res = rnd(b, n, ho, wo).to(torch.bfloat16) if add == "res" else None
    st = gn_stats(x, 32 if c % 32 == 0 else c, 1e-5)  # conv_in's 4 channels: 4 groups
    kern = lambda: qconv3(xq, wq, w_scale, bias, s_x, stride, film, res)
    plain = lambda: qconv3_plain(xq, wq, w_scale, bias, s_x, stride, film, res, torch.bfloat16)
    kern_gn = lambda: qconv3_gn(x, st, gamma, beta, s_x, wq, w_scale, bias, True, stride,
                                film, res)
    plain_gn = lambda: qconv3_gn_plain(x, st, gamma, beta, s_x, wq, w_scale, bias, True,
                                       stride, film, res)
    err, rel, ok = compare(kern(), plain())
    err_gn, rel_gn, ok_gn = compare(kern_gn(), plain_gn())
    # yardsticks: the bf16 convolution the exact path runs (cuDNN, channels
    # last), and torch._int_mm on the im2col matrix (the same MACs, K and N
    # padded to multiples of 8, without the im2col's own time)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    w_bf = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    lib = lambda: F.conv2d(x_cl, w_bf, bias, stride, 1)
    kpad, npad = -(-9 * c // 8) * 8, -(-n // 8) * 8
    a_im2col = torch.randint(-127, 128, (b * ho * wo, kpad), device="cuda",
                             generator=gen).to(torch.int8)
    b_im2col = torch.randint(-127, 128, (npad, kpad), device="cuda",
                             generator=gen).to(torch.int8).t()
    int_mm = lambda: torch._int_mm(a_im2col, b_im2col)
    torch.cuda.synchronize()
    eager = dict(ms=time_ms(kern, 20), gn_ms=time_ms(kern_gn, 20),
                 plain_ms=time_ms(plain, 3, warmup=1), library_ms=time_ms(lib, 20),
                 int_mm_ms=time_ms(int_mm, 20))
    ms, gn_ms = time_graph_ms(kern), time_graph_ms(kern_gn)
    plain_ms, gn_plain_ms = time_graph_ms(plain, 2, 2), time_graph_ms(plain_gn, 2, 2)
    lib_ms, int_mm_ms = time_graph_ms(lib), time_graph_ms(int_mm)
    ops = 2.0 * b * ho * wo * n * 9 * c
    out_bytes = 2 * b * ho * wo * n * (2 if add == "res" else 1)
    nbytes = xq.numel() + wq.numel() + out_bytes
    bound_ms, bound_by = _bound(nbytes, ops / PEAK_INT8)
    gn_bound_ms, _ = _bound(nbytes + x.numel(), ops / PEAK_INT8)
    return dict(shape=list(spec), max_abs_err=max(err, err_gn), rel_l2_err=max(rel, rel_gn),
                ok=ok and ok_gn, ms=ms, gn_ms=gn_ms, plain_ms=plain_ms, gn_plain_ms=gn_plain_ms,
                library_ms=lib_ms, library="F.conv2d bf16 channels_last (cuDNN)",
                int_mm_ms=int_mm_ms, bound_ms=bound_ms, gn_bound_ms=gn_bound_ms,
                bound_by=bound_by, eager=eager, bound_detail=dict(bytes=nbytes, ops=ops))


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = [
        ("flash_fwd", "cuda", "vdtpu_torch/csrc/flash_fwd.cu",
         "vdtpu/ops/pallas/flash.py:40", _attention_case, FLASH_SHAPES),
        ("flash_bwd", "cuda", "vdtpu_torch/csrc/flash_bwd.cu",
         "vdtpu/ops/pallas/flash.py:444", _flash_bwd_case, FLASH_SHAPES),
        ("gn_silu", "triton", "vdtpu_torch/ops/gn_silu.py",
         "vdtpu/ops/pallas/gn_silu.py:45", _gn_case, GN_SHAPES),
        ("nomax_fwd", "cuda", "vdtpu_torch/csrc/nomax_fwd.cu",
         "vdtpu/ops/pallas/flash.py:223", functools.partial(_attention_case, nomax=True),
         NOMAX_SHAPES),
        ("gn_silu_q", "triton", "vdtpu_torch/ops/gn_silu.py",
         "vdtpu/ops/pallas/gn_silu.py:155", _gn_q_case, GN_SHAPES),
        ("qconv3", "cuda", "vdtpu_torch/csrc/qconv3.cu",
         "vdtpu/ops/pallas/qconv.py:149", _qconv_case, QCONV_SHAPES),
    ]
    failed = []
    for name, route, source, replaces, case, shapes in specs:
        rows = []
        for shape in shapes:
            r = case(shape, gen)
            rows.append(r)
            extra = {k: v for k, v in r.items() if k not in (
                "shape", "max_abs_err", "ok", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "eager", "bound_detail", "library")}
            log(f"kernel {name} {shape}: max_abs_err {r['max_abs_err']:.3e} ok {r['ok']} | "
                f"device ms (graph) {r['ms']:.4f} plain {r['plain_ms']:.4f} library "
                f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}) | "
                f"{json.dumps(extra)} | eager ms {json.dumps(r['eager'])} [{state.get('card')}]")
            if not r["ok"]:
                failed.append(f"{name}{shape}")
            torch.cuda.empty_cache()
        head = rows[0]  # the first shape is the main path's dominant site
        state["kernels"][name] = dict(
            name=name, route=route, source=source, replaces=replaces, launches=None,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=head.get("library"), shape=head["shape"],
            shapes=rows)
        if name == "flash_bwd":  # _bwd_impl's two TPU kernels: dq :444, dk/dv :474
            state["kernels"][name]["replaces_also"] = "vdtpu/ops/pallas/flash.py:474"
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: {failed}")


def derandomize_zeros(module, seed: int, std: float = 0.02):
    """Fill every all-zero parameter (zero-initialized output convs and
    biases) with small normals, so every block contributes to the output."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    with torch.no_grad():
        for p in module.parameters():
            if p.numel() and not bool(p.any()):
                p.copy_(torch.randn(p.shape, device=p.device, generator=gen) * std)
                n += 1
    return n


def _gn_sites(system) -> int:
    """GroupNorm calls of one request: every GN module of the image
    diffuser's data blocks and the text diffuser's context blocks runs once
    per UNet call, every VAE-decoder GN once per decode."""
    from vdtpu_torch.models.layers import GroupNorm32
    count = lambda mods: sum(isinstance(m, GroupNorm32) for mod in mods for m in mod.modules())
    unet = (count(system.model.diffuser["image"].data_blocks)
            + count(system.model.diffuser["text"].context_blocks))
    return unet, count([system.vae["image"].decoder])


def _system(state):
    """The full-width bf16 system with seeded random weights, built once."""
    import torch
    from vdtpu_torch.serving.api import VDSystem
    if "system" not in state:
        t0 = time.perf_counter()
        system = VDSystem("vd_four_flow_v1-0", dtype=torch.bfloat16, device="cuda")
        system.init_random(SEED)
        nz = derandomize_zeros(system.net, SEED + 1)
        system.cast(torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in system.net.parameters())
        log(f"system: built {n_params / 1e6:.1f} M params ({nz} zero tensors randomized) "
            f"in {time.perf_counter() - t0:.1f} s")
        state["system"] = system
    return state["system"]


def phase_main(state):
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    unet_gn, vae_gn = _gn_sites(system)
    expect = {"flash_fwd": 10 * STEPS, "gn_silu": unet_gn * STEPS + vae_gn}
    prompt = "a red cat sitting on a wooden bench in the sun"
    results = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        gn_silu.launches = 0
        t = time.perf_counter()
        img = vdi.inference_t2i(prompt, seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(img).all())
        lo, hi = float(img.min()), float(img.max())
        shape_ok = tuple(img.shape) == (2, 512, 512, 3)
        log(f"main {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak {peak:.2f} GiB, "
            f"shape {tuple(img.shape)} finite {finite} range [{lo:.4f}, {hi:.4f}], "
            f"launches {counts} (expected {expect}) [{state.get('card')}]")
        if not (finite and shape_ok and lo >= 0.0 and hi <= 1.0):
            raise RuntimeError(f"main {run}: bad output")
        if counts != expect:
            raise RuntimeError(f"main {run}: launch counts {counts} != {expect}")
        results[run] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak, launches=counts)
    for name, n in results["warm"]["launches"].items():
        if name in state["kernels"]:
            state["kernels"][name]["launches"] = n
            state["kernels"][name]["path"] = "main (bf16 exact, warm request)"
    state["main"] = results


def phase_eps(state):
    import torch
    from vdtpu_torch.models.vd import VDModel
    system = _system(state)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen).to(torch.bfloat16)
    t = torch.tensor([500], device="cuda")
    ctx = system.ctx_encode(stand_in_tokenizer(["a red cat"]), "text")
    with torch.no_grad():
        eps_gpu = system.model.apply_model(x, t, ctx, "image", "text").float().cpu()
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_model = VDModel.from_config(system.cfg)
    cpu_model.diffuser.to_empty(device="cpu")
    cpu_model.diffuser.load_state_dict(
        {k: v.float().cpu() for k, v in system.model.diffuser.state_dict().items()})
    with torch.no_grad():
        eps_cpu = cpu_model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                        "image", "text")
    dt = time.perf_counter() - t0
    a, b = eps_gpu.flatten().double(), eps_cpu.flatten().double()
    cos = float(a @ b / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    log(f"eps: card bf16 vs cpu f32 at [1, 4, 64, 64]: cosine {cos:.6f} rel_l2 {rel:.5f} "
        f"(limits cos >= {EPS_MIN_COS}, rel_l2 <= {EPS_MAX_REL_L2}); cpu {dt:.1f} s "
        f"[{state.get('card')}]")
    state["eps"] = dict(cosine=cos, rel_l2=rel)
    if not (math.isfinite(cos) and cos >= EPS_MIN_COS and rel <= EPS_MAX_REL_L2):
        raise RuntimeError("eps: card result disagrees with the f32 CPU result")


def _ctx_tokens(unet, latent: int):
    """Token count of each context block of a 2-D UNet walk on a latent of
    side ``latent``: Downsample halves the side, Upsample doubles it."""
    side, di, out = latent, 0, []
    for tok in unet.program.layer_order:
        if tok == "d":
            kind = unet.program.data[di].kind
            side = side // 2 if kind == "down" else side * 2 if kind == "up" else side
            di += 1
        elif tok == "c":
            out.append(side * side)
    return out


def _int8_sites(system):
    """(calibrated int8 conv sites of the image data blocks, those of them
    that are ResBlock convs behind a GroupNorm, QDense sites of the text
    context blocks): each runs once per UNet call."""
    from vdtpu_torch.models.blocks import ResBlock2D
    from vdtpu_torch.ops.quant import QConv, QDense
    img, txt = system.model.diffuser["image"], system.model.diffuser["text"]
    convs = sum(isinstance(m, QConv) and m.act_scale is not None
                for m in img.data_blocks.modules())
    gn_convs = sum(conv.act_scale is not None for m in img.data_blocks.modules()
                   if isinstance(m, ResBlock2D) for conv in (m.in_layers[2], m.out_layers[3]))
    mms = sum(isinstance(m, QDense) and m.w_q is not None for m in txt.context_blocks.modules())
    return convs, gn_convs, mms


def _int8_launches(system, tome_ratio: float | None):
    """Launches of one int8 request, derived from the program: per UNet call
    (x STEPS) every calibrated conv site of the image data blocks runs the
    int8 conv kernel; every QDense of the text context blocks one
    torch._int_mm; every self-attention whose (merged) length reaches the
    flash rule (q >= 256, kv >= 1024) the no-max kernel, and nothing the
    exact flash kernel (every such site has a shift); the GroupNorms and
    the VAE decoder as in the bf16 request. Also the no-max launches by kv
    length: ToMe merges each 4096-token site to 4096 - merge_count."""
    from vdtpu_torch.ops.tome import merge_count
    convs, _, mms = _int8_sites(system)
    by_kv = {}
    for n in _ctx_tokens(system.model.diffuser["image"], 64):
        if tome_ratio is not None and n >= 4096:
            n -= merge_count(n, tome_ratio)
        if n >= 1024:
            by_kv[n] = by_kv.get(n, 0) + STEPS
    unet_gn, vae_gn = _gn_sites(system)
    return {"flash_fwd": 0, "nomax_fwd": sum(by_kv.values()), "qconv3": convs * STEPS,
            "int_mm": mms * STEPS, "gn_silu": unet_gn * STEPS + vae_gn}, by_kv


def _counters():
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_q, gn_stats
    from vdtpu_torch.ops.nomax import flash_attention_nomax
    from vdtpu_torch.ops.qconv import qconv3, qconv3_gn
    from vdtpu_torch.ops.quant import int8_linear
    return {"flash_fwd": flash_attention, "nomax_fwd": flash_attention_nomax,
            "qconv3": qconv3, "qconv3_gn": qconv3_gn, "int_mm": int8_linear,
            "gn_silu": gn_silu, "gn_silu_q": gn_silu_q, "gn_stats": gn_stats}


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0
    _counters()["nomax_fwd"].launches_by_kv.clear()


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


@contextlib.contextmanager
def _recording(name: str, calls: list):
    """Record the arguments of every call the int8 sites make to
    ``vdtpu_torch.ops.quant.<name>`` (the conv wrappers), calling through."""
    from vdtpu_torch.ops import quant
    inner = getattr(quant, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(quant, name, record)
    try:
        yield
    finally:
        setattr(quant, name, inner)


def _site_check(state, label: str, calls, kern, plain):
    """The kernel against its plain version on the recorded arguments of
    each distinct site shape (input shape, C_out, stride, which adds): the
    real activations, scales and weight tables of that site."""
    import torch
    seen, rows = set(), []
    for args, kwargs in calls:
        a = list(args) + [None] * (12 - len(args))
        if label == "qconv3":   # (xq [B,H,W,C], wq, ..., stride, add_vec, add_full, dtype)
            sig = (tuple(a[0].shape), a[1].shape[0], a[5], a[6] is not None, a[7] is not None)
        else:                   # (x [B,C,H,W], stats, gamma, beta, s_x, wq, ..., stride, ...)
            sig = (tuple(a[0].shape), a[5].shape[0], a[9], a[10] is not None, a[11] is not None)
        if sig in seen:
            continue
        seen.add(sig)
        err, rel, ok = compare(kern(*args, **kwargs), plain(*args, **kwargs))
        torch.cuda.synchronize()
        rows.append(dict(site=list(sig), max_abs_err=err, rel_l2_err=rel, ok=ok))
    bad = [r["site"] for r in rows if not r["ok"]]
    log(f"  site check {label}: {len(rows)} distinct sites of {len(calls)} calls, max_abs_err "
        f"{max(r['max_abs_err'] for r in rows):.3e}, max rel_l2 "
        f"{max(r['rel_l2_err'] for r in rows):.3e}, disagreeing {bad} [{state.get('card')}]")
    if bad:
        raise RuntimeError(f"{label} disagrees with its plain version at sites {bad}")
    if "qconv3" in state["kernels"]:
        k = state["kernels"]["qconv3"]
        k.setdefault("site_checks", {})[label] = rows
        k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in rows))
    return rows


def phase_main_int8(state):
    import torch
    from vdtpu_torch.ops.qconv import qconv3, qconv3_plain
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    system.enable_int8(image_size=512, n=2)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t
    log(f"main_int8: enable_int8(image_size=512, n=2) calibration {calib_s:.3f} s "
        f"[{state.get('card')}]")
    # every int8 conv site of the request (one CFG UNet call at batch 4 on
    # the 64^2 latent) against the plain version, on its own arguments
    calls = []
    xs, ts, cs = _eps_inputs(system, 4)
    with torch.no_grad(), _recording("qconv3", calls):
        system.model.apply_model(xs, ts, cs, "image", "text")
    _site_check(state, "qconv3", calls, qconv3, qconv3_plain)
    del calls
    torch.cuda.empty_cache()
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    prompt = "a red cat sitting on a wooden bench in the sun"
    results = {"calibration_s": calib_s}
    by_kv_now = _counters()["nomax_fwd"].launches_by_kv
    try:
        for mode, ratio in (("int8", None), ("int8_tome", TOME_RATIO)):
            system.enable_tome(ratio or 0)
            expect, expect_kv = _int8_launches(system, ratio)
            for run in ("cold", "warm"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counters()
                t = time.perf_counter()
                img = vdi.inference_t2i(prompt, seed=SEED)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                got, by_kv = _read_counters(), dict(by_kv_now)
                counts = {k: got[k] for k in expect}
                peak = torch.cuda.max_memory_allocated() / 2**30
                finite = bool(torch.isfinite(img).all())
                lo, hi = float(img.min()), float(img.max())
                log(f"main_int8 {mode} {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak "
                    f"{peak:.2f} GiB, shape {tuple(img.shape)} finite {finite} range "
                    f"[{lo:.4f}, {hi:.4f}], launches {counts} (expected {expect}), no-max by "
                    f"kv length {by_kv} (expected {expect_kv}) [{state.get('card')}]")
                if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0
                        and hi <= 1.0):
                    raise RuntimeError(f"main_int8 {mode} {run}: bad output")
                if counts != expect or got["qconv3_gn"] or got["gn_silu_q"] or got["gn_stats"]:
                    raise RuntimeError(f"main_int8 {mode} {run}: launch counts {got} != {expect}")
                if by_kv != expect_kv:
                    raise RuntimeError(f"main_int8 {mode} {run}: no-max launches by kv length "
                                       f"{by_kv} != {expect_kv}")
                results[f"{mode}_{run}"] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak,
                                                launches=counts, nomax_by_kv=by_kv)
    finally:
        system.enable_tome(0)
    for name in ("nomax_fwd", "qconv3"):
        if name in state["kernels"]:
            state["kernels"][name]["launches"] = results["int8_warm"]["launches"][name]
            state["kernels"][name]["path"] = "main_int8 (int8, warm request)"
    state["main_int8"] = results


def _eps_inputs(system, batch: int):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn(batch, 4, 64, 64, device="cuda", generator=gen).to(system.dtype)
    t = torch.full((batch,), 500, device="cuda")
    ctx = system.ctx_encode(stand_in_tokenizer(["a red cat"] * batch), "text")
    return x, t, ctx


def _cosine(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm())), float((a - b).norm() / b.norm())


@contextlib.contextmanager
def _policy(system, policy):
    """Run under ``policy`` (None: the exact path), then restore the system's."""
    prev = system.quant_policy
    system.set_quant_policy(policy)
    try:
        yield
    finally:
        system.set_quant_policy(prev)


def _int8_eps(system, x, t, ctx):
    """(int8 eps, int8's own error: its relative L2 distance to the exact
    bf16 eps of the same system on the same inputs)."""
    import torch
    run = lambda: system.model.apply_model(x, t, ctx, "image", "text").float()
    with torch.no_grad():
        eps = run()
        with _policy(system, None):
            exact = run()
    return eps, _cosine(eps, exact)[1]


def phase_modes(state):
    import torch
    from vdtpu_torch.ops.qconv import qconv3_gn, qconv3_gn_plain
    from vdtpu_torch.ops.quant import QuantPolicy
    system = state.get("system")
    if system is None or system.quant_policy is None:
        raise RuntimeError("modes needs the calibrated system of main_int8")
    x, t, ctx = _eps_inputs(system, 2)
    base, effect = _int8_eps(system, x, t, ctx)
    convs, gn_convs, mms = _int8_sites(system)
    attn = _int8_launches(system, None)[0]["nomax_fwd"] // STEPS
    log(f"modes: int8 eps against the exact bf16 eps (int8's own error): rel_l2 {effect:.5f}")
    results, totals, calls = {"int8_rel_l2_to_exact": effect}, {}, []
    for mode, pol in (("gn_prologue=fused", QuantPolicy(gn_prologue="fused")),
                      ("gn_prologue=stats", QuantPolicy(gn_prologue="stats")),
                      ("conv=fused", QuantPolicy(conv="fused"))):
        rec = _recording("qconv3_gn", calls) if mode == "conv=fused" else contextlib.nullcontext()
        with torch.no_grad(), _policy(system, pol), rec:
            torch.cuda.synchronize()
            _zero_counters()
            eps = system.model.apply_model(x, t, ctx, "image", "text").float()
            torch.cuda.synchronize()
            got = _read_counters()
        cos, rel = _cosine(eps, base)
        # routing: every calibrated conv site runs int8 (per site or fused),
        # every ResBlock conv behind a GroupNorm takes the mode's prologue,
        # and every fused site its own statistics
        prologue = {"gn_prologue=fused": got["gn_silu_q"], "gn_prologue=stats": got["gn_stats"],
                    "conv=fused": got["qconv3_gn"]}[mode]
        routed = (got["qconv3"] + got["qconv3_gn"] == convs and got["nomax_fwd"] == attn
                  and got["int_mm"] == mms and got["flash_fwd"] == 0
                  and (prologue == gn_convs if mode != "conv=fused"
                       else 0 < prologue == got["gn_stats"] and got["gn_silu_q"] == 0))
        log(f"modes {mode}: eps [2, 4, 64, 64] against the default mode: cosine {cos:.6f} "
            f"rel_l2 {rel:.5f} (limits cos >= {INT8_MIN_COS}, rel_l2 <= {INT8_MAX_REL_L2}); "
            f"launches {got} (int8 conv sites {convs}, of them behind a GroupNorm {gn_convs}, "
            f"no-max {attn}, int_mm {mms}; routed {routed}) [{state.get('card')}]")
        results[mode] = dict(cosine=cos, rel_l2=rel, launches=got, routed=routed)
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        if not (math.isfinite(rel) and rel <= INT8_MAX_REL_L2 and cos >= INT8_MIN_COS):
            raise RuntimeError(f"modes {mode}: rel_l2 {rel}, cosine {cos} outside the limits")
        if not routed:
            raise RuntimeError(f"modes {mode}: launch counts {got} do not match the policy")
    _site_check(state, "qconv3_gn", calls, qconv3_gn, qconv3_gn_plain)
    del calls
    if "gn_silu_q" in state["kernels"]:
        k2 = state["kernels"]["gn_silu_q"]
        k2["launches"] = totals["gn_silu_q"] + totals["gn_stats"]
        k2["launches_by_wrapper"] = {"gn_silu_q": totals["gn_silu_q"],
                                     "gn_stats": totals["gn_stats"]}
        k2["path"] = "modes (one eps call per opt-in mode)"
        state["kernels"]["qconv3"]["launches_gn_prologue"] = totals["qconv3_gn"]
    state["modes"] = results


def phase_eps_int8(state):
    import torch
    from vdtpu_torch.models.vd import VDModel
    from vdtpu_torch.ops.quant import load_quant_state, quant_state, set_quant_policy
    system = state.get("system")
    if system is None or system.quant_policy is None:
        raise RuntimeError("eps_int8 needs the calibrated system of main_int8")
    x, t, ctx = _eps_inputs(system, 1)
    eps_gpu, effect = _int8_eps(system, x, t, ctx)
    eps_gpu = eps_gpu.cpu()
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_model = VDModel.from_config(system.cfg)
    cpu_model.diffuser.to_empty(device="cpu")
    cpu_model.diffuser.load_state_dict(
        {k: v.float().cpu() for k, v in system.model.diffuser.state_dict().items()})
    set_quant_policy(cpu_model.diffuser, system.quant_policy)
    load_quant_state(cpu_model.diffuser,
                     {k: v.cpu() for k, v in quant_state(system.model.diffuser).items()})
    with torch.no_grad():
        eps_cpu = cpu_model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                        "image", "text")
    dt = time.perf_counter() - t0
    cos, rel = _cosine(eps_gpu, eps_cpu)
    log(f"eps_int8: card bf16 int8 vs cpu f32 int8 (same scales) at [1, 4, 64, 64]: cosine "
        f"{cos:.6f} rel_l2 {rel:.5f} (limits cos >= {INT8_MIN_COS}, rel_l2 <= "
        f"{INT8_MAX_REL_L2}; int8's own error on the card, against the exact bf16 eps: rel_l2 "
        f"{effect:.5f}); cpu {dt:.1f} s [{state.get('card')}]")
    state["eps_int8"] = dict(cosine=cos, rel_l2=rel, int8_rel_l2_to_exact=effect)
    if not (math.isfinite(rel) and rel <= INT8_MAX_REL_L2 and cos >= INT8_MIN_COS):
        raise RuntimeError("eps_int8: card result disagrees with the f32 CPU result")


def _fingerprint(t):
    """An int64 sum of a tensor's bit patterns: equal before and after iff no
    element changed (short of changes that cancel exactly)."""
    import torch
    bits = t.detach().view(torch.int32) if t.element_size() == 4 else t.detach().view(torch.int16)
    return int(bits.sum(dtype=torch.int64))


@contextlib.contextmanager
def _plain_kernels():
    """Route the training path's kernel calls (flash forward and backward,
    GN+SiLU) to their plain versions on the card, for the reference
    gradient; the kernel wrappers themselves never fall back."""
    from vdtpu_torch.ops import flash, gn_silu
    saved = flash.flash_attention_fwd, flash.flash_attention_bwd, gn_silu._gn_silu_fwd

    def fwd(q, k, v, scale, with_lse=False):
        res = flash.flash_attention_plain(q, k, v, scale, with_lse)
        return res if with_lse else (res, None)

    flash.flash_attention_fwd, flash.flash_attention_bwd = fwd, flash.flash_attention_bwd_plain
    gn_silu._gn_silu_fwd = gn_silu.gn_silu_plain
    try:
        yield
    finally:
        flash.flash_attention_fwd, flash.flash_attention_bwd, gn_silu._gn_silu_fwd = saved


def _train_counters():
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from vdtpu_torch.ops.gn_silu import gn_silu
    return {"flash_fwd": flash_attention, "flash_bwd": flash_attention_bwd, "gn_silu": gn_silu}


def _train_grads(loss_fn, params, x, ctx, t, noise):
    """One micro-batch's gradients by name (moved out of .grad), its loss
    and the launch counts of the call."""
    import torch
    for p in params.values():
        p.grad = None
    for c in _train_counters().values():
        c.launches = 0
    loss, _ = loss_fn(x, ctx, t, noise)
    loss.backward()
    torch.cuda.synchronize()
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    return grads, loss.item(), {k: c.launches for k, c in _train_counters().items()}


def phase_train(state):
    """t2i training at full width through ``Trainer``, on pre-encoded batches
    (the harness's default contract; the VAE encoder is not ported, so the
    latents are seeded normals)."""
    import gc
    import torch
    from vdtpu_torch.serving.api import VDSystem
    from vdtpu_torch.training.harness import Trainer, make_loss_fn
    from vdtpu_torch.training.optim import get_optimizer, parameter_group_of
    from vdtpu_torch.training.schedulers import get_scheduler
    state.pop("system", None)  # free the serving system of the earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.float32, device="cuda",
                      use_checkpoint=False)
    system.init_random(SEED)
    nz = derandomize_zeros(system.net, SEED + 1)
    params = system.for_training(torch.bfloat16)
    model = system.model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompts = [f"a photo of a {w} on a table in the morning light" for w in (
        "cat", "dog", "red apple", "blue cup", "lamp", "book", "violin", "plant")]
    ctx = system.ctx_encode(stand_in_tokenizer(prompts), "text")
    x = torch.randn(TRAIN_BATCH, 4, 64, 64, device="cuda", generator=gen)
    torch.cuda.synchronize()
    frozen = {k for k in params if parameter_group_of(k) in TRAIN_FREEZE}
    log(f"train: system {sum(p.numel() for p in params.values()) / 1e6:.1f} M diffuser "
        f"params in f32 ({nz} zero tensors randomized), frozen "
        f"{sum(params[k].numel() for k in frozen) / 1e6:.1f} M, context {tuple(ctx.shape)}, "
        f"latents {tuple(x.shape)}, built in {time.perf_counter() - t0:.1f} s")

    # one micro-batch-2 gradient: kernels against plain versions on the card
    loss_fn = make_loss_fn(model, "image", "text", TRAIN_FREEZE)
    t_mb = torch.tensor([100, 700], device="cuda")
    noise = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
    args = (x[:2], ctx[:2], t_mb, noise)
    g_kern, loss_k, counts_k = _train_grads(loss_fn, params, *args)
    with _plain_kernels():
        g_plain, loss_p, counts_p = _train_grads(loss_fn, params, *args)
    if set(g_kern) != set(g_plain):
        raise RuntimeError("train: the two gradient runs reached different parameters")
    dot = na = nb = nd = 0.0
    for k, a in g_kern.items():
        a, b = a.double(), g_plain[k].double()
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
        nd += float(((a - b) ** 2).sum())
    cos, rel = dot / math.sqrt(na * nb), math.sqrt(nd / nb)
    n_gn = _gn_sites(system)[0]
    expect_mb = {"flash_fwd": 10, "flash_bwd": 10, "gn_silu": n_gn}
    log(f"train: micro-batch-2 gradient of {len(g_kern)} tensors "
        f"({sum(g.numel() for g in g_kern.values()) / 1e6:.1f} M), kernels vs plain on the "
        f"card: cosine {cos:.6f} rel_l2 {rel:.5f} (limits cos >= {TRAIN_MIN_COS}, rel_l2 <= "
        f"{TRAIN_MAX_REL_L2}); loss {loss_k:.6f} vs {loss_p:.6f}; launches {counts_k} "
        f"(expected {expect_mb}), plain run {counts_p} [{state.get('card')}]")
    del g_kern, g_plain
    if not (math.isfinite(cos) and cos >= TRAIN_MIN_COS and rel <= TRAIN_MAX_REL_L2):
        raise RuntimeError("train: the kernels' gradient disagrees with the plain versions'")
    if counts_k != expect_mb or any(counts_p.values()):
        raise RuntimeError(f"train: gradient-check launches {counts_k} / {counts_p}")
    gc.collect()
    torch.cuda.empty_cache()

    opt, set_lr = get_optimizer("adamw", params, TRAIN_PG_LRSCALE, TRAIN_FREEZE,
                                weight_decay=0.01)
    sched = get_scheduler({"type": "stable_diffusion_linear", "base_lr": 1e-7},
                          global_batch_size=TRAIN_BATCH, gradacc_every=TRAIN_ACCUM)
    trainer = Trainer(model, params, opt, set_lr, sched, x_type="image", c_type="text",
                      ema_decay=0.9999, grad_accum=TRAIN_ACCUM, freeze_groups=TRAIN_FREEZE,
                      log_every=1)
    before = {k: _fingerprint(p) for k, p in params.items()}
    batches = [{"x": x, "ctx": ctx}] * (TRAIN_STEPS + 1)
    expect = {"flash_fwd": 10 * TRAIN_ACCUM, "flash_bwd": 10 * TRAIN_ACCUM,
              "gn_silu": n_gn * TRAIN_ACCUM}
    steps = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        for c in _train_counters().values():
            c.launches = 0
        t = time.perf_counter()
        trainer.run(batches, num_iters=i + 1, seed=SEED)
        loss = trainer.last_loss  # waits for the step
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {k: c.launches for k, c in _train_counters().items()}
        steps.append(dict(seconds=dt, loss=loss, launches=counts))
        log(f"train step {i + 1}: {dt:.3f} s, {TRAIN_BATCH / dt:.3f} images/s, loss "
            f"{loss:.6f}, launches {counts} (expected {expect}) [{state.get('card')}]")
        if not math.isfinite(loss):
            raise RuntimeError(f"train step {i + 1}: loss {loss}")
        if counts != expect:
            raise RuntimeError(f"train step {i + 1}: launch counts {counts} != {expect}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    touched = {k for k, p in params.items() if p.grad is not None}
    moved = {k for k, p in params.items() if _fingerprint(p) != before[k]}
    frozen_moved = frozen & moved
    untouched = set(params) - touched - frozen
    log(f"train: {len(touched)} tensors with gradients ({sum(params[k].numel() for k in touched) / 1e6:.1f}"
        f" M), {len(touched & moved)} moved; frozen moved {len(frozen_moved)} of {len(frozen)}; "
        f"non-frozen without gradients on this flow {len(untouched)} "
        f"({sum(params[k].numel() for k in untouched) / 1e6:.1f} M, decay only), moved "
        f"{len(untouched & moved)}; EMA updates {trainer.state.ema.num_updates}; optimizer "
        f"groups {[(g['label'], len(g['params'])) for g in opt.param_groups]}")
    if frozen_moved or touched - moved or trainer.state.ema.num_updates != TRAIN_STEPS:
        raise RuntimeError(f"train: frozen moved {sorted(frozen_moved)[:3]}, trainable not "
                           f"moved {sorted(touched - moved)[:3]}, EMA count "
                           f"{trainer.state.ema.num_updates}")

    # one more step under the profiler: device busy and idle share
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t = time.perf_counter()
        trainer.run(batches, num_iters=TRAIN_STEPS + 1, seed=SEED)
        trainer.last_loss
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = _device_rows(prof)
    busy = sum(_dev_t(e) for e in rows) / 1e6
    kinds: dict[str, float] = {}
    for e in rows:
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) + _dev_t(e) / 1e6
    log(f"train profile (one step): wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}, {sum(e.count for e in rows)} kernels [{state.get('card')}]")
    for kind, sec in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  kind {kind}: {1e3 * sec:.2f} ms ({sec / max(busy, 1e-12):.3f})")
    for e in sorted(rows, key=_dev_t, reverse=True)[:10]:
        log(f"  top {_dev_t(e) / 1e3:.3f} ms x{e.count} {e.key[:90]}")

    warm = steps[1:]
    step_s = sum(r["seconds"] for r in warm) / len(warm)
    log(f"train: warm step {step_s:.3f} s ({TRAIN_BATCH / step_s:.3f} images/s, global batch "
        f"{TRAIN_BATCH}, grad_accum {TRAIN_ACCUM}, 512^2), cold step {steps[0]['seconds']:.3f} s, "
        f"peak {peak:.2f} GiB, launches per step {expect} [{state.get('card')}]")
    state["train"] = dict(warm_step_s=step_s, images_per_s=TRAIN_BATCH / step_s,
                          cold_step_s=steps[0]["seconds"], peak_gib=peak, steps=steps,
                          grad_cosine=cos, grad_rel_l2=rel,
                          profile=dict(wall_s=wall, busy_s=busy, kinds=kinds))
    for name, n in steps[-1]["launches"].items():
        k = state["kernels"].get(name)
        if k is None:
            continue
        if name == "flash_bwd":
            k["launches"] = n
            k["path"] = "train (one optimizer step, global batch 8, grad_accum 2)"
        else:
            k["launches_train_step"] = n
    del trainer, opt, params, system, model
    gc.collect()
    torch.cuda.empty_cache()


def _dev_t(e) -> float:
    """Self device time of a profiler row, us."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def _device_rows(prof):
    """The profiler's device rows that are kernels and copies: the GPU spans
    of annotated ranges (``Optimizer.step#AdamW.step``) would count their
    kernels' time twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_t(e)
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "flash_bwd" in n:
        return "flash bwd (hand)"
    if "flash_fwd" in n:
        return "flash (hand)"
    if "nomax_fwd" in n:
        return "nomax (hand)"
    if "qconv3" in n:
        return "int8 conv (hand)"
    if "gn_stats" in n or "gn_apply" in n or "gn_finalize" in n:
        return "gn_silu (hand)"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout conversion (cuDNN)"
    if any(k in n for k in ("conv", "implicit", "winograd", "fprop", "dgrad")):
        return "convolution (cuDNN)"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    if "softmax" in n:
        return "softmax"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled", "reduce", "copy",
                            "cat", "fill", "index", "upsample")):
        return "elementwise/copy/reduce"
    return "other"


def _profile_mode(state, system, label):
    """The warm request split into its stages, and one CFG UNet step under
    torch.profiler, under the system's current policy."""
    import torch
    ids = stand_in_tokenizer(["", "a red cat sitting on a wooden bench in the sun"])
    sync = torch.cuda.synchronize
    sync()
    t = time.perf_counter()
    ctx = system.ctx_encode(ids[:1], "text"), system.ctx_encode(ids[1:], "text")
    sync()
    t_ctx = time.perf_counter() - t
    u, c = (e.repeat(2, 1, 1) for e in ctx)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t = time.perf_counter()
    z = system.sampler.sample(gen, STEPS, (2, 64, 64, 4), {"type": "image"},
                              {"type": "text", "conditioning": c,
                               "unconditional_conditioning": u,
                               "unconditional_guidance_scale": 7.5},
                              dtype=system.dtype, device="cuda")
    sync()
    t_sample = time.perf_counter() - t
    t = time.perf_counter()
    system.vae_decode(z, "image")
    sync()
    t_dec = time.perf_counter() - t
    log(f"profile {label} stages: text encode x2 {1e3 * t_ctx:.1f} ms, DDIM-{STEPS} "
        f"{1e3 * t_sample:.1f} ms ({1e3 * t_sample / STEPS:.2f} ms/step), VAE decode "
        f"{1e3 * t_dec:.1f} ms [{state.get('card')}]")

    x = torch.randn(4, 4, 64, 64, device="cuda", generator=gen).to(system.dtype)
    tt = torch.full((4,), 500, device="cuda")
    cc = torch.cat([u, c])
    step = lambda: system.model.apply_model(x, tt, cc, "image", "text")
    iters = 5
    with torch.no_grad():
        for _ in range(3):
            step()
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            t = time.perf_counter()
            for _ in range(iters):
                step()
            sync()
            wall = (time.perf_counter() - t) / iters
    rows = _device_rows(prof)
    busy = sum(_dev_t(e) for e in rows) / iters / 1e3  # ms per step
    n_kernels = sum(e.count for e in rows) / iters
    log(f"profile {label} UNet step (batch 4 = 2 x CFG, 64^2 latent): wall {1e3 * wall:.2f} "
        f"ms, device busy {busy:.2f} ms, idle share {1 - busy / (1e3 * wall):.3f}, "
        f"{n_kernels:.0f} kernels/step [{state.get('card')}]")
    if not rows:
        log("profile: the profiler saw no device time")
        return
    kinds: dict[str, float] = {}
    for e in rows:
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) + _dev_t(e)
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  kind {kind}: {us / iters / 1e3:.3f} ms/step ({us / iters / 1e3 / busy:.3f})")
    for e in sorted(rows, key=_dev_t, reverse=True)[:12]:
        log(f"  top {_dev_t(e) / iters / 1e3:.3f} ms/step x{e.count // iters} {e.key[:90]}")
    state.setdefault("profile", {})[label] = dict(wall_ms=1e3 * wall, busy_ms=busy,
                                                  kinds=kinds)


def phase_profile(state):
    """Profile the exact path, and int8 and int8 + ToMe once calibrated."""
    system = _system(state)
    policy = system.quant_policy
    with _policy(system, None):
        _profile_mode(state, system, "exact")
    if policy is None:
        return
    _profile_mode(state, system, "int8")
    try:
        system.enable_tome(TOME_RATIO)
        _profile_mode(state, system, "int8_tome")
    finally:
        system.enable_tome(0)


def main() -> int:
    global _LOG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {set(phases) - set(PHASES)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    import vdtpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    os.makedirs("chiprun_out", exist_ok=True)
    _LOG = open(os.path.join("chiprun_out", "chip_smoke.log"), "w")
    state = {"kernels": {}}
    try:
        t_all = time.perf_counter()
        for phase in PHASES:
            if phase not in phases:
                continue
            t = time.perf_counter()
            globals()[f"phase_{phase}"](state)
            log(f"phase {phase}: {time.perf_counter() - t:.1f} s")
        log(f"all phases: {time.perf_counter() - t_all:.1f} s")
    finally:
        _LOG.close()
    if {"main", "main_int8", "modes", "train"} <= set(phases):
        missing = [k for k, v in state["kernels"].items() if not v["launches"]]
        if missing:
            raise RuntimeError(f"kernels never launched on the main path: {missing}")
    print(state.get("card", ""))
    print(json.dumps({"kernels": list(state["kernels"].values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

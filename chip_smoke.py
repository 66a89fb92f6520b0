#!/usr/bin/env python3
"""Drive the PyTorch port's text-to-image main path on one CUDA card.

    python3 chip_smoke.py            # the default phases, on one card

Phases (each one's failure fails the run; nothing falls back to the CPU):
  device   require CUDA; print the card's name and power limit
  build    compile every CUDA source (one nvcc each, in parallel) and the
           Triton kernels; print the seconds
  kernels  each kernel against its plain version at the main path's shapes:
           max error, kernel / plain / library-call ms and the bound (bytes
           or operations over the card's peak). "ms" is device time (calls
           captured in a CUDA graph, replayed between CUDA events); the
           "eager" times are the same calls launched one by one, host
           launch costs included
  main     vd_four_flow_v1-0 at full width in bf16, seeded random weights,
           inference_t2i at 512^2, n = 2, DDIM-50, CFG 7.5, cold then warm;
           the launch counters are zeroed just before each run and read
           just after it
  eps      one full-width UNet eps call on the card (bf16) against the port
           on the CPU in f32, same weights and inputs
  profile  (not run by default) the warm request split into its stages,
           and one CFG UNet step under torch.profiler: device busy and
           idle share, kernel time by kind and the top kernels

It prints the card line and a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. ``--phases`` runs a subset (development
only; the summary lines then cover what ran). Outputs too long for the end
of the log go to ``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import zlib

PHASES = ("device", "build", "kernels", "main", "eps", "profile")
DEFAULT_PHASES = PHASES[:-1]

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# and the special-function units' exponentials: 16 per SM per clock on 132
# SMs at the 1.98 GHz boost clock.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_EXP = 16 * 132 * 1.98e9

FLASH_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
GN_SHAPES = [(4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 16, 16), (4, 2560, 8, 8),
             (2, 128, 512, 512)]
# |kernel - plain| <= ATOL + RTOL * |plain|: two bf16 ulps at the output's
# magnitude; both sides read the same bf16 inputs and differ only in the
# order of f32 sums and where the output is rounded
ATOL, RTOL = 1e-2, 1.6e-2
# eps call, bf16 on the card vs f32 on the CPU through the full-width UNet
EPS_MIN_COS, EPS_MAX_REL_L2 = 0.995, 0.05
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
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")
    x = torch.randn(2, 64, 4, 4, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    for silu in (True, False):  # compile both Triton specializations
        gn_silu(x, w, w, 32, 1e-5, silu)
    torch.cuda.synchronize()
    state["build_s"] = time.perf_counter() - t0
    log(f"build: nvcc {t_nvcc:.2f} s, with triton {state['build_s']:.2f} s")


def _flash_case(shape, gen):
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
    b, n, h, d = shape
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kern = lambda: flash_attention(q, k, v)
    plain = lambda: flash_attention_plain(q, k, v)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=time_ms(lib, 20))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2), time_graph_ms(lib)
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4.0 * b * h * n * n * d
    exps = float(b * h * n * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, max(flops / PEAK_BF16, exps / PEAK_EXP)
    return dict(shape=list(shape), max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations", eager=eager,
                bound_detail=dict(bytes=nbytes, flops=flops, exps=exps))


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
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return dict(shape=list(shape), max_abs_err=worst[0], rel_l2_err=worst[1], ok=worst[2],
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", eager=eager,
                bound_detail=dict(bytes=nbytes, flops=flops))


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = [
        ("flash_fwd", "cuda", "vdtpu_torch/csrc/flash_fwd.cu",
         "vdtpu/ops/pallas/flash.py:40", _flash_case, FLASH_SHAPES),
        ("gn_silu", "triton", "vdtpu_torch/ops/gn_silu.py",
         "vdtpu/ops/pallas/gn_silu.py:45", _gn_case, GN_SHAPES),
    ]
    failed = []
    for name, route, source, replaces, case, shapes in specs:
        rows = []
        for shape in shapes:
            r = case(shape, gen)
            rows.append(r)
            e = r["eager"]
            log(f"kernel {name} {shape}: max_abs_err {r['max_abs_err']:.3e} "
                f"rel_l2_err {r['rel_l2_err']:.3e} ok {r['ok']} | device ms (graph) "
                f"{r['ms']:.4f} plain {r['plain_ms']:.4f} library {r['library_ms']:.4f} "
                f"bound {r['bound_ms']:.4f} ({r['bound_by']}) | eager ms {e['ms']:.4f} "
                f"plain {e['plain_ms']:.4f} library {e['library_ms']:.4f} "
                f"[{state.get('card')}]")
            if not r["ok"]:
                failed.append(f"{name}{shape}")
            torch.cuda.empty_cache()
        head = rows[0]  # the first shape is the main path's dominant site
        state["kernels"][name] = dict(
            name=name, route=route, source=source, replaces=replaces, launches=None,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            rel_l2_err=max(r["rel_l2_err"] for r in rows), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"], shapes=rows)
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


def phase_main(state):
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference, VDSystem
    t0 = time.perf_counter()
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.bfloat16, device="cuda")
    system.init_random(SEED)
    nz = derandomize_zeros(system.net, SEED + 1)
    system.cast(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in system.net.parameters())
    log(f"main: built {n_params / 1e6:.1f} M params ({nz} zero tensors randomized) "
        f"in {time.perf_counter() - t0:.1f} s")
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
    state["main"] = results
    state["system"] = system


def phase_eps(state):
    import torch
    from vdtpu_torch.models.vd import VDModel
    from vdtpu_torch.serving.api import VDSystem
    system = state.get("system")
    if system is None:
        system = VDSystem("vd_four_flow_v1-0", dtype=torch.bfloat16, device="cuda")
        system.init_random(SEED)
        derandomize_zeros(system.net, SEED + 1)
        system.cast(torch.bfloat16)
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


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash (hand)"
    if "gn_stats" in n or "gn_apply" in n:
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


def phase_profile(state):
    import torch
    from torch.autograd import DeviceType
    system = state.get("system")
    if system is None:
        raise RuntimeError("profile needs the main phase's system")
    vdi_steps = STEPS
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
    z = system.sampler.sample(gen, vdi_steps, (2, 64, 64, 4), {"type": "image"},
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
    log(f"profile stages: text encode x2 {1e3 * t_ctx:.1f} ms, DDIM-{vdi_steps} "
        f"{1e3 * t_sample:.1f} ms ({1e3 * t_sample / vdi_steps:.2f} ms/step), VAE decode "
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
    dev_t = lambda e: (getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0))
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_t(e)]
    busy = sum(dev_t(e) for e in rows) / iters / 1e3  # ms per step
    n_kernels = sum(e.count for e in rows) / iters
    log(f"profile UNet step (batch 4 = 2 x CFG, 64^2 latent): wall {1e3 * wall:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / (1e3 * wall):.3f}, "
        f"{n_kernels:.0f} kernels/step [{state.get('card')}]")
    if not rows:
        log("profile: the profiler saw no device time")
        return
    kinds: dict[str, float] = {}
    for e in rows:
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) + dev_t(e)
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  kind {kind}: {us / iters / 1e3:.3f} ms/step ({us / iters / 1e3 / busy:.3f})")
    for e in sorted(rows, key=dev_t, reverse=True)[:12]:
        log(f"  top {dev_t(e) / iters / 1e3:.3f} ms/step x{e.count // iters} {e.key[:90]}")
    state["profile"] = dict(wall_ms=1e3 * wall, busy_ms=busy, kinds=kinds)


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
    if "main" in phases:
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

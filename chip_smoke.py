#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (text-to-image, image variation,
image-to-text and text-to-text, the multi-context blends, int8 serving,
the serving queue and CLI, the VAE loss, the eval stage and the
serving-policy gate, the Mosaic probes, t2i training, the training
launcher and its data path, data and tensor parallelism over
torch.distributed with ranks sharing the card, the legacy diffuser zoo
and vd_inference) on one CUDA card.

    python3 chip_smoke.py            # the default phases, on one card

Phases (each one's failure fails the run; nothing falls back to the CPU):
  device    require CUDA; print the card's name and power limit
  build     compile every CUDA source (one nvcc each, in parallel) and the
            Triton kernels; print the seconds, each nvcc's too
  kernels   each kernel against its plain version at the main paths'
            shapes (the flash forward and backward also on their f32 route
            at FLASH_SHAPES, in f32 with TF32 off: the tf32x3 kernels, with
            the SIMT f32 kernels checked and timed beside them through their
            own C entries, and both bounds, 3xTF32 and f32 FMAs): max error,
            kernel / plain / library-call ms and the
            bound (bytes or operations over the card's peak). "ms" is device
            time (calls captured in a CUDA graph, replayed between CUDA
            events); the "eager" times are the same calls launched one by
            one, host launch costs included. The attention forwards are
            held on both of their kernels (the wgmma one at the main
            paths' shapes, the mma.sync one at ``*_MMA_SHAPES``; the
            flash forward also at the four-image mcg request's
            cross-attentions, ``FLASH_XATTN_SHAPES``: 1028 keys); the
            forwards at heads of 88-160 (``FLASH_WIDE_SHAPES``: the wgmma
            kernel's wide heads in Flash, FlashLse and NoMax, timed in turns
            against the mma.sync kernel they replaced and against SDPA;
            ``FLASH_F32_WIDE_SHAPES``: the wide tf32x3 kernel against the
            SIMT kernel and SDPA f32), the
            whole-ResBlock kernel on both of its routes (halo at the
            UNet's sites, general at ``RESBLOCK_GENERAL_SHAPES``), the GN
            kernel on both of its routes (``GN_ROUTES``: resident at the
            UNet's maps, the text sites and a VAE cluster of 2, streaming
            at the VAE's 512^2 map), the int8 GN kernels (gn_silu_q and
            gn_stats) at every distinct int8 GroupNorm site of the UNet
            (``GNQ_SHAPES``: gn_silu_q streaming, gn_stats a CTA a group)
            and on their general route (``GNQ_ODD_SHAPES``), each launch's
            path asserted; the serving queue's bucket batches too (8 images:
            the UNet at batch 16 for the attention forwards, the GN kernel,
            the int8 conv and the whole-ResBlock kernel, the decoder at 8;
            1 image: the UNet at batch 2); the legacy zoo's sites
            (``FLASH_QKV_SHAPES``: the AttentionBlock's q, k, v as strided
            views of its fused qkv, both orders; ADM's GN sites at 256^2 with
            SiLU and 128^2 without, ``GN_NO_SILU``)
  main      vd_four_flow_v1-0 at full width in bf16, seeded random weights,
            inference_t2i at 512^2, n = 2, DDIM-50, CFG 7.5, cold then warm;
            the launch counters are zeroed just before each run and read
            just after it
  main_f32  the same request at the port's default dtype: the system in
            f32 (seeded as main), once (the process warm from main), every
            flash launch on the tf32x3 kernel (500), peak GiB; one f32 eps call against f32 on
            the CPU with the card's default TF32 flags (printed; cuDNN's
            convs run TF32: F32_EPS_MAX_REL_L2) and with TF32 off
            (F32_EPS_NO_TF32_MAX_REL_L2); main_mcg's four-image mcg (c) in
            f32, once: 1250 flash launches, all tf32x3 (250 on the wide
            kernel), output finite, in [0, 1], of its shape, every distinct
            flash site against its plain version in f32
  main_i2i  inference_i2i on the same system, exact bf16, on a seeded 512^2
            image: (a) fid 0, focus 0.5, no colour adjust (50 steps) and
            (b) fid 0.5, focus 0.3, "Simple" (25 steps: VAE encoder, x0
            start, focus filter, colour adjust), each once, with
            their launch counts; regularize_image on a non-512^2 image
  main_text inference_i2t on the seeded 512^2 image of main_i2i and
            inference_t2t on a prompt, exact bf16, n = 4, DDIM-50, CFG 7.5,
            then the 29-step GPT-2 decode of the Optimus text VAE, each once
            with its launch counts; every decoded row is checked
            (BOS first, EOS by the last step, ids inside the vocabulary);
            one full-width text-diffuser eps call per context type (at the
            requests' batch 8) and the first decode step's logits against
            f32 on the CPU; the GN kernel against its plain version, with
            and without SiLU, at every distinct GroupNorm site of those two
            calls, on the site's own arguments; the bf16 and f32 decodes on
            shared Gumbel draws, rows that agree counted
  main_mcg  the multi-context blends on the same system, exact bf16, n = 2,
            DDIM-50, CFG 7.5, seeded 512^2 images: (a) inference_dcg (one
            image, focus 0.5, a prompt at strength 0.5), (b) inference_tcg
            given three images (it keeps two; the second masked) and a
            prompt at 0.3, (c) inference_mcg with four images and no prompt
            (1028 context tokens: the cross-attentions take the flash
            kernel, d 160 the wgmma kernel's wide heads), each once, with the
            inputs shown and the launch counts by path derived from the
            program; one full-width multi-context eps call (text + image)
            under attention mixing and one under a layer-mixing draw, each
            against f32 on the CPU
  main_modes the sampler modes on the same system, exact bf16, n = 2, CFG 7.5,
            each request once: (a) t2i under DPM-Solver++(2M), 20
            steps; (b) t2i under encoder_reuse=2 (warmup 5), 50 steps; (c)
            t2i under cfg_interval=(0.1, 0.8), 50 steps (the steps outside
            at half batch); (d) t2i, DPM-Solver++ 20 + encoder reuse 2; (e)
            main_mcg's tcg request (b) under encoder reuse 2; (f) i2i (fid
            0.5, x0 start) under DPM-Solver++, 20 steps. Each request's
            flash and GN launches, by path and route, are derived from the
            layer program (the input half runs on key steps only; GN
            routes from gn_plan at each step's batch); the VAE's GN
            launches are read from one decode (and encode). Then one
            full-width split walk (input half, then the mid and output walk
            from its cache) against the full walk, and cfg_interval=(0, 1)
            against plain CFG on the t2i request, each bit-equal or within
            relative L2 MODE_MAX_REL_L2; the exact t2i request warm is the
            yardstick of the modes' (first) times
  eps       one full-width UNet eps call on the card (bf16) against the port
            on the CPU in f32, same weights and inputs
  main_legacy the legacy diffuser zoo (vdtpu_torch/models/legacy.py) at
            published widths, seeded weights (zero tensors redrawn), bf16,
            one family built at a time and freed after: (a) UNetModelVD at
            VD v1's widths: a t2i request through cfg_eps_fn + ddim_loop over
            its image route (the serving system's CLIP text tower, DDIM-50,
            CFG 7.5, n = 2, KL-f8 decode to 512^2) cold then warm, the text
            route sampled 50 steps on [2, 768] latents, one eps call a
            (xtype, ctype) route and forward_dc at r = 0.3 (the image route
            also against f32 on the CPU); (b) SD v1 (openai_unet), ADM
            ImageNet-256 (openai_unet: scale-shift, resblock up/down, 1000
            classes, legacy qkv order, 256^2 pixels), the dual-context
            family (which 0, 1, a 0.3 blend of 77 text and 257 image tokens),
            no-context, no-attention, decoder-only, 2d, 0d and 0dmd, one eps
            call each at batch 2; every call against the same module in f32
            on the card (TF32 off; EPS_MIN_COS / EPS_MAX_REL_L2), every
            distinct GN and flash site against its plain version on its
            recorded input, flash launches by path and GN launches by route
            derived from the layer program (``legacy_sites``); (c)
            vd_inference(fp16=True, checkpoint=...) on the serving system's
            weights saved as a .pt into memory: its t2i request bit-equal to
            the serving system's on the same dict
  main_int8 the calibrated int8 serving policy on the same system:
            enable_int8 over vdtpu's four flows (calibration, timed); the
            int8 conv kernel against
            its plain version at every distinct conv site of one UNet call,
            on that site's own arguments; then the same request once as
            (a) int8 and (b) int8 + ToMe 0.75, each with its launch
            counts of the no-max (also by kv length: ToMe's merged sites),
            int8 conv and torch._int_mm paths, and the int8 conv's launches
            by tile-plan path (halo or general) against qconv3_plan's; then
            main_mcg's tcg request (b) under int8 + ToMe 0.75, once,
            with its launch counts; then one int8 + ToMe 0.75 t2i
            request under encoder_reuse=2 (the split walk on the no-max,
            int8 conv and GN kernels), launches derived per half
  modes     one full-width int8 eps call in each opt-in policy mode
            (gn_prologue "fused" and "stats", conv "fused") against the
            default mode's, with each mode's launch counts derived from the
            program (the int8 GN kernels' also by route), and the
            fused-prologue conv against its plain version at every distinct
            site of its call; then t2i requests under the default int8
            policy, gn_prologue "fused", gn_prologue "stats", conv "fused"
            and the default again, each once (times recorded beside each
            other, the opt-in modes' launch counts asserted)
  eps_int8  one full-width int8 eps call on the card (bf16) against the
            port's int8 plain path on the CPU in f32, same scales (the CPU
            call runs in a thread during main_parallel, whose process waits
            on its ranks, where that phase runs too)
  main_fused2 QuantPolicy(conv="fused2") on the calibrated system: the
            whole-ResBlock kernel against its plain version at every
            distinct fused2 site of one UNet call (the site's own
            arguments), one eps call against conv="fused", then t2i and i2i
            (a) requests once with their launch counts (the
            whole-ResBlock kernel's also by resblock_plan route)
  main_queue the serving queue (vdtpu_torch.serving.queue.BatchingQueue,
            buckets 1, 2, 4, 8) on the same system: ToMe's merge timed at
            TOME_SHAPES (deterministic, against the scatter_add_ merge it
            replaced); (a) 8 concurrent exact t2i requests as one bucket of
            8 (the UNet at batch 16), DDIM-50, once, with peak memory,
            launches and GN routes derived from the program, and one
            profiled batch-16 CFG step;
            (d) the bucket's first request alone at bucket 1, within
            QUEUE_MAX_REL_L2 / QUEUE_MIN_COS of its bucket-8 image, and (c)
            bit-equal to inference_t2i at n = 1; (b) a request in two
            buckets of 8 with other co-riders, bit-equal, and (c) bucket 1
            against the direct call, under exact, int8 and int8 + ToMe 0.75
            (QUEUE_STEPS steps; int8 launches derived); (e) one request of
            each of the seven flows in one sweep, each equal to its direct
            call at n = 1; (f) the CLI (``cli.main``) for t2i (PNGs read
            back) and t2t on a synthetic CLIP vocabulary
  main_quality the slice-16 path, on systems of its own beside the serving one:
            (a) KL-f8's reconstruction pass at 256^2, batch 2, f32 with grad
            (AutoencoderKL.forward), LPIPS + PatchGAN generator loss with the
            adaptive weight and its backward, then the discriminator loss;
            every term against the same modules in f32 on the CPU (TF32
            off, QUALITY_LOSS_RTOL), running statistics moved by the
            discriminator branch only, GN launches of one encoder and
            decoder pass, the GN kernel against its plain version at every
            distinct f32 site of that pass (GN_F32_ATOL / GN_F32_RTOL);
            (b) the eval stage (training/launch.py::build_eval,
            EvalStage) on the serving system: two batches of 2 stand-in
            captions, exact DDIM-50, CLIP-sim, then one batch at
            DPM-Solver++ 20 scored with CLIP-FID against seeded reals, each
            batch's flash and GN launches derived; (c) the serving-policy
            gate (vdtpu_torch.quality.main, its systems cut to three levels,
            LAUNCH_LEVELS, to keep the default run in its time limit) in the
            random-fill and surrogate
            regimes and its calibration sweep ("none", QUALITY_SWEEP) in the
            surrogate one: every variant's launches derived as main_int8 and
            main_modes derive them, rows finite, the exact row bit-equal
            across two runs, each row printed with README's verdict (within
            0.5 dB of the int8 row's PSNR and |CLIP-sim delta| <= 0.002 in
            both regimes; a finding, not a check)
  probes    the port's counterpart of scripts/mosaic_probe.py, through its
            entry point vdtpu_torch.probes.main(): the s8 matmul, shifted
            slice-add and scratch slice-write kernels at the script's shapes,
            each exact against its plain version and the script's check
  train     t2i training at full width: frees the serving system, builds
            vd_four_flow_v1-0 with f32 parameters (bf16 compute, no remat),
            encodes 8 stand-in prompts, holds one micro-batch-2 gradient of
            the trainable tree through the kernels against the same
            gradient through the plain versions, then runs Trainer steps
            (global batch 8 at 512^2, grad_accum 2, AdamW with the t2i
            experiment's groups, EMA 0.9999), each with its launch counts;
            one more step under torch.profiler
  main_launch the training launcher (vdtpu_torch.training.launch.main) at full
            width: (a) PNG shards synthesized (2 x 24 at 512^2, 4 at 640x576)
            and data.benchmark's images/s at 1 and 4 threads (host work);
            (b) a run of vd_laion_t2i from a seeded bf16 pretrained .pt and a
            synthetic CLIP vocabulary: bf16 compute, global batch 8, gradacc
            2, a latent cache of 3 batches encoded in chunks of 4 (the
            towers freed after it), text data frozen, 4 steps, async saves
            every 2: losses finite, frozen tensors unchanged, trained ones
            moved, iter_2 / iter_4 / last on disk, the towers' memory before
            and after, peak, cold and warm step, launches a step as derived;
            (c) the run from iter_2 to step 4 again, within
            LAUNCH_RESUME_BOUND x its lr sum of (b)'s parameters, and a
            resume to 6 ("resumed ... at step 4"); (d) --eval of the EMA
            shadow, one batch of 2, DDIM-50, CFG 7.5: summary.yaml and its
            launches; then on a system of its own at the same three levels
            (with the Optimus VAE):
            (h) f32 compute, a micro-batch-2 gradient through the flash
            kernels' f32 route against the plain versions (TF32 off), every
            launch on the tf32x3 kernels; (e) the text flow's gradient (Optimus latents)
            against the plain versions, the GN kernel at the text diffuser's
            sites, two Trainer steps; (f) two t2i steps with the CLIP text
            tower trained inside the loss; (g) two steps on bf16 master
            weights, peak beside (b)'s
  main_parallel data and tensor parallelism over torch.distributed on the
            one card, at full width: (a) the launcher under torchrun, NCCL,
            world size 1, PAR_ITERS steps of main_launch's experiment (three
            levels, global batch 8, gradacc 2) on PAR_SHARDS shards whose
            samples are all one seeded 512^2 PNG and caption; (b) the same
            under torchrun with two ranks sharing the card over gloo (dp =
            2): losses within PAR_LOSS_RTOL of (a)'s, the replicas' parameter
            and EMA hashes equal after every step, each rank's peak, step s
            and the all-reduce's share; (c) ``parallel.dryrun`` at tp = 2
            and three levels: one CFG eps call (batch PAR_TP_BATCH), its
            model output against one process (PAR_EPS_MIN_COS,
            PAR_EPS_MAX_REL_L2) and its guided eps against f32 beside one
            process's (PAR_EPS_F32_RATIO); two Trainer steps, gradients
            and parameters against one process (TRAIN_MIN_COS,
            TRAIN_MAX_REL_L2), launches per rank; (d) the
            dry run at dp = 2 and three levels: a 2-image t2i at DDIM-50,
            CFG 7.5, and a
            BatchingQueue at bucket 2 on a leader and a follower, each image
            against the one-process request (QUEUE_MAX_REL_L2,
            QUEUE_MIN_COS); (e) the utilities: a UNet step traced by
            ``utils.profiling.trace`` and broken down by ``summarize_trace``,
            ``utils.debug.checked`` on a clean and a NaN-injected UNet call,
            ``device_memory_stats``. (a) and (b) run at once, as do (c) and
            (d), with (e) in this process meanwhile: the processes share the
            card and the host, so their step times are not one run's alone.
            Every rank runs under a timeout; a rank
            that fails or hangs fails the phase. The launcher runs save no
            checkpoint (a call may write 45 GiB to the disk, and main_launch
            writes most of it)
  gn_sweep  (not run by default) the GN kernel's plan measured: the card's
            cluster capacities against gn_silu.GN_CLUSTERS, and at
            ``GN_SWEEP_SHAPES`` both routes at every cluster size the kernel
            takes there, each held to its plain version, against the plan's
            choice
  gnq_sweep (not run by default) the int8 GN kernels' plan measured: at
            ``GNQ_SWEEP_SHAPES`` every geometry gnq_variants gives (Cs,
            threads, pixels a tile) of gn_silu_q and gn_stats, each held to
            its plain version, against the plan's choice (gn_stats: a CTA a
            group and the cooperative kernel); the card's blocks per SM
            against the plan's assumption; one traced launch of gn_silu_q's
            plan (each CTA's phases, us)
  gnq_compare (not run by default) gn_silu_q and gn_stats through the
            package's wrappers at GNQ_SHAPES, each against its plain version,
            device (graph) and eager ms; then warm t2i requests on the
            calibrated system, the default int8 policy and
            gn_prologue="fused" in turn (``GNQ_COMPARE_ROUNDS`` of each).
            It assumes no plan, route or counter of the kernels, so a copy of
            this script placed at another checkout's root times that
            checkout's package the same way, in the same call
  wide_sweep (not run by default) the wgmma forward's wide heads at other
            block heights and key tiles than its plan's (WIDE_SWEEP_VARIANTS,
            built from csrc/attn_fwd_sm90.cuh into a library of their own),
            each held to the plain version and timed in turns with the
            plan's launch at WIDE_SWEEP_SHAPES
  profile   (not run by default) the warm request split into its stages,
            and one CFG UNet step under torch.profiler (exact, int8, int8 +
            ToMe, int8 gn_prologue="fused" and int8 conv="fused2"): device
            busy and idle share, kernel time by kind, the int8 conv's, the
            whole-ResBlock kernel's and the int8 GN kernels' device ms, and
            the top kernels

It prints the card line and a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. ``--phases`` runs a subset (development
only; the summary lines then cover what ran). Outputs too long for the end
of the log go to ``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib

PHASES = ("device", "build", "kernels", "main", "main_f32", "main_i2i", "main_text", "main_mcg",
          "main_modes", "eps", "main_legacy",
          "main_int8", "modes", "eps_int8", "main_fused2", "main_queue", "main_quality", "probes",
          "train", "main_launch", "main_parallel",
          "profile", "gn_sweep", "gnq_sweep", "gnq_compare", "wide_sweep")
DEFAULT_PHASES = PHASES[:-5]

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# and the special-function units' exponentials: 16 per SM per clock on 132
# SMs at the 1.98 GHz boost clock.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_EXP = 16 * 132 * 1.98e9
# int32 adds outside the tensor cores: 64 lanes per SM per clock
PEAK_INT32 = 64 * 132 * 1.98e9

FLASH_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# the flash wrappers' f32 plan paths (the tf32x3 kernels, the SIMT ones),
# which no bf16 path launches
F32_PATHS = ("f32", "tf32x3")
# the flash forward at half batch: the UNet's self-attention sites on the
# steps outside the cfg interval (main_modes (c))
FLASH_HALF_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80)]
# the attention forwards at the serving queue's full bucket: 8 images, the
# UNet's self-attention sites at batch 16 (main_queue (a); bucket 1 is
# FLASH_HALF_SHAPES' batch 2)
ATTN_BUCKET_SHAPES = [(16, 4096, 8, 40), (16, 1024, 8, 80)]
# no-max attention: int8 exact (4096 and 1024 tokens) and the ToMe 0.75
# site (4096 tokens merged to 1024 at d_head 40)
NOMAX_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 40), (4, 1024, 8, 80)] + ATTN_BUCKET_SHAPES
# shapes that take the two forwards' mma.sync kernels, which no main-path
# site reaches (heads over 160, d % 8 != 0 and unaligned views go there):
# (B, N, H, D, elements q, k and v start into their buffers); element loads
# at an offset of one and at d 36 (the TPU's _nomax_kernel case), 16-byte
# cp.async loads at d 168
FLASH_MMA_SHAPES = [(4, 1024, 8, 40, 1), (4, 1024, 8, 168, 0)]
# the flash forward at a four-image mcg request's cross-attentions
# (main_mcg (c)): 4 x 257 = 1028 image tokens as keys, a ragged last key
# tile, under the queries of the 64^2, 32^2 and 16^2 maps; (B, N, H, D,
# offset, keys). d 160 takes the wgmma kernel's wide heads
# (csrc/attn_fwd_wide.cu)
FLASH_XATTN_SHAPES = [(4, 4096, 8, 40, 0, 1028), (4, 1024, 8, 80, 0, 1028),
                      (4, 256, 8, 160, 0, 1028)]
NOMAX_MMA_SHAPES = [(4, 1024, 8, 36, 0), (4, 1024, 8, 168, 0)]
# the forwards at heads of 88-160 (csrc/attn_fwd_wide.cu in bf16 for Flash,
# FlashLse and NoMax; csrc/tf32x3_fwd_wide.cu in f32): the mcg's 16^2
# cross-attention first, then a d-128 self-attention; (B, N, H, D, offset,
# keys) in bf16, (B, N, H, D, keys) in f32. Each is timed in turns against
# the kernel it replaced (mma.sync; SIMT f32) and against SDPA.
FLASH_WIDE_SHAPES = [(4, 256, 8, 160, 0, 1028), (4, 1024, 8, 128, 0, 1024)]
FLASH_F32_WIDE_SHAPES = [(4, 256, 8, 160, 1028), (4, 1024, 8, 128, 1024)]
# the legacy AttentionBlock's flash site (main_legacy (b), ADM ImageNet-256
# at its 32^2 map: 1024 tokens, 8 heads of 64, CFG batch 2): q, k and v as
# strided views of one fused qkv projection, [B, N, H, 3, d] (legacy order)
# or [B, N, 3, H, d] (new order), as the block hands them over
FLASH_QKV_SHAPES = [(2, 1024, 8, 64, "legacy"), (2, 1024, 8, 64, "new")]
# int8 3x3 conv: (B, C_in, H, W, C_out, stride, add); the first is the
# commonest site (64^2 ResBlock conv with its FiLM vector); 64^2, 32^2 and
# 16^2 maps are the int8 sites' three sizes
QCONV_SHAPES = [(4, 320, 64, 64, 320, 1, "film"), (4, 4, 64, 64, 320, 1, None),
                (4, 960, 64, 64, 320, 1, "res"), (4, 320, 64, 64, 320, 2, None),
                (4, 1280, 16, 16, 1280, 1, "film"), (4, 640, 32, 32, 640, 1, "film"),
                # the serving queue's full bucket: 8 images, the UNet at batch 16
                (16, 320, 64, 64, 320, 1, "film")]
GN_SHAPES = [(4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 16, 16), (4, 2560, 8, 8),
             (2, 128, 512, 512)]
# the int8 GN kernels (gn_silu_q, gn_stats): the distinct int8 GroupNorm
# sites of the full-width UNet at B = 4 (2 x CFG), the ResBlock GroupNorms
# on maps of at least 256 pixels (tests/test_torch_gnq_plan.py derives them
# from the config literals; the modes phase from the model), the commonest
# first; then shapes that take the kernels' general route (rows that are not
# 16-byte runs, one pixel a channel, C % 16 != 0 in groups of 5, conv_in's
# 4 channels in 4 groups for the codes), with their groups
GNQ_SHAPES = [(4, 320, 64, 64), (4, 640, 64, 64), (4, 960, 64, 64), (4, 320, 32, 32),
              (4, 640, 32, 32), (4, 960, 32, 32), (4, 1280, 32, 32), (4, 1920, 32, 32),
              (4, 640, 16, 16), (4, 1280, 16, 16), (4, 1920, 16, 16), (4, 2560, 16, 16)]
GNQ_ODD_SHAPES = [(2, 96, 7, 9), (3, 320, 33, 17), (1, 64, 1, 1), (2, 40, 5, 3), (4, 4, 64, 64)]
GNQ_GROUPS = {(2, 40, 5, 3): 8, (4, 4, 64, 64): 4}
# the int8 GN plan's deciding sites (gnq_sweep): the commonest 64^2 site,
# the streaming 960-channel one, a 32^2 site of several ranges a channel,
# the widest 32^2 one, a 16^2 site of one range, and the commonest site at
# batch 2 (the modes phase's eps calls)
GNQ_SWEEP_SHAPES = [(4, 320, 64, 64), (4, 960, 64, 64), (4, 640, 32, 32), (4, 1920, 32, 32),
                    (4, 1280, 16, 16), (2, 320, 64, 64)]
# gnq_compare: warm requests of each policy, taken in turn (the host's load
# moves a request's time by up to 20% from call to call)
GNQ_COMPARE_ROUNDS = 5
# wide_sweep: (B, N, H, D, keys) and the (padded head, consumer warpgroups,
# key tile) variants of the wgmma forward's wide heads timed against the
# plan's own (one warpgroup over <= 256 queries, 64-key tiles past d 128)
WIDE_SWEEP_SHAPES = [(4, 256, 8, 160, 1028), (4, 4096, 8, 160, 1028), (4, 1024, 8, 96, 1024),
                     (4, 1024, 8, 128, 1024)]
WIDE_SWEEP_VARIANTS = [(160, 2, 64), (160, 1, 64), (160, 1, 128), (96, 2, 128), (96, 1, 128),
                       (128, 2, 128), (128, 2, 64), (128, 1, 128)]
# its library: the variants' instantiations with hidden visibility (a
# template instantiated in csrc/attn_fwd_wide.cu's library too would
# otherwise bind to that library's copy and its launch setup)
WIDE_SWEEP_SRC = """#include "attn_fwd_sm90.cuh"
extern "C" __attribute__((visibility("default"))) int vd_wide_sweep(
    int variant, const void* q, const void* k, const void* v, void* o, int B, int N, int M,
    int H, int D, long long sqb, long long sqn, long long sqh, long long skb, long long skn,
    long long skh, long long svb, long long svn, long long svh, long long sob, long long son,
    long long soh, float qscale, void* stream) {
  vdattn::Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.B = B; a.N = N; a.M = M; a.H = H; a.D = D;
  a.sqb = sqb; a.sqn = sqn; a.sqh = sqh; a.skb = skb; a.skn = skn; a.skh = skh;
  a.svb = svb; a.svn = svn; a.svh = svh; a.sob = sob; a.son = son; a.soh = soh;
  a.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
CASES
    default: return int(cudaErrorInvalidValue);
  }
}
"""
# the GN kernel's shapes in the kernels phase, each with gn_plan's route
# (asserted a launch): GN_SHAPES (the UNet's maps resident, the VAE's 512^2 map
# streaming: its CTAs would take more than one wave), the commonest
# text-diffuser sites, an FC block's [8, F, 1] and a context block's
# [8, C, 4] (resident, flat layout in bf16), and a resident band of a
# cluster of 2 (the VAE's 64^2 map)
GN_ROUTES = {(4, 320, 64, 64): "resident", (4, 640, 32, 32): "resident",
             (4, 1280, 16, 16): "resident", (4, 2560, 8, 8): "resident",
             (2, 128, 512, 512): "streaming", (8, 1280, 1): "resident",
             (8, 320, 4): "resident", (2, 512, 64, 64): "resident",
             # the UNet's maps at half batch (main_modes (c): the steps outside
             # the cfg interval), resident in clusters of 2 and 1
             (2, 320, 64, 64): "resident", (2, 960, 64, 64): "resident",
             (2, 640, 32, 32): "resident", (2, 1280, 16, 16): "resident",
             (2, 2560, 8, 8): "resident",
             # the serving queue's full bucket (main_queue (a)): the UNet's maps
             # at batch 16 (the 64^2 one streams: its resident CTAs would take
             # more than a wave) and the decoder's 512^2 and 64^2 maps at 8
             (16, 320, 64, 64): "streaming", (16, 640, 32, 32): "resident",
             (16, 1280, 16, 16): "resident", (16, 2560, 8, 8): "resident",
             (8, 128, 512, 512): "streaming", (8, 512, 64, 64): "streaming",
             # ADM ImageNet-256 (main_legacy (b)) at batch 2: the 256^2 map of
             # 256 channels (GN + SiLU) and a scale-shift FiLM norm (no SiLU)
             # at 128^2
             (2, 256, 256, 256): "streaming", (2, 256, 128, 128): "resident"}
# GN_ROUTES sites timed without SiLU (the scale-shift FiLM norms); the rest
# are timed with it
GN_NO_SILU = {(2, 256, 128, 128)}
# the GN plan's deciding sites (gn_sweep): the commonest UNet map, the
# 960-channel 64^2 UNet site (two waves of resident CTAs), and the VAE's maps
# at batch 2 from 64^2 (resident, clusters of 2) to 512^2 (streaming)
GN_SWEEP_SHAPES = [(4, 320, 64, 64), (4, 960, 64, 64), (2, 512, 64, 64), (2, 512, 128, 128),
                   (2, 256, 256, 256), (2, 128, 512, 512)]
# whole int8 ResBlock (B, C_in, H, W, C_out): the 8 distinct conv="fused2"
# sites of the full-width UNet at B = 4 (2 x CFG), the commonest first
RESBLOCK_SHAPES = [(4, 320, 64, 64, 320), (4, 640, 64, 64, 320), (4, 960, 64, 64, 320),
                   (4, 320, 32, 32, 640), (4, 640, 32, 32, 640), (4, 1920, 32, 32, 640),
                   (4, 1280, 32, 32, 640), (4, 960, 32, 32, 640),
                   # the serving queue's buckets of 8 and 1 images (UNet batch 16, 2)
                   (16, 320, 64, 64, 320), (2, 320, 64, 64, 320)]
# a ResBlock that takes the kernel's general route (the mma.sync implicit
# GEMM, GN2 statistics a pass over the mid), which no UNet site reaches:
# 96 output channels, which no halo N tile divides, at the 64^2 map
RESBLOCK_GENERAL_SHAPES = [(4, 320, 64, 64, 96)]
# |kernel - plain| <= ATOL + RTOL * |plain|: two bf16 ulps at the output's
# magnitude; both sides read the same bf16 inputs and differ only in the
# order of f32 sums and where the output is rounded
ATOL, RTOL = 1e-2, 1.6e-2
# the same band for the GN kernel on f32 inputs (the VAE loss pass): the
# card tests' f32 GN tolerance, 1e-5 absolute and relative
GN_F32_ATOL, GN_F32_RTOL = 1e-5, 1e-5
# relative L2 error of an attention forward against its plain version: the
# sound kernels read 2.4e-3 (flash, whose p is rounded against a running
# max) and 2.0e-4 (no-max) at [4, 4096, 8, 40]; leaving out one 128-key
# tile of 4096 moves the output by about sqrt(128 / 4096) = 0.18 of its
# norm, which the elementwise band above lets through where |out| ~ 0.03
ATTN_MAX_REL_L2 = 1e-2
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
# whole-ResBlock kernel against its plain version, fixed before its first
# run: both sum the GN statistics in f32 in other orders, so a code flips
# where y / s lies within f32 rounding of a half-integer (and a flipped mid
# code moves the GN2 statistics); at most this share of the elements may
# leave the two-ulp band above, and the relative L2 error stays under 1e-2
RB_MAX_OUTSIDE, RB_MAX_REL_L2 = 1e-3, 1e-2
I2I_FID_STEPS = 25   # request (b): fid 0.5 runs half of the 50 steps
# the Mosaic probes' shapes (scripts/mosaic_probe.py): s8 [M, K] x [K, N],
# the shifted slice-add's i32 [M, C], the scratch write's bf16 [M, C]
PROBE_MM_SHAPES = [(4096, 2880, 128)]
PROBE_SHIFT_SHAPES = [(1056, 320)]
PROBE_SCRATCH_SHAPES = [(512, 320)]
# text flows: the first GPT-2 decode step's logits, bf16 on the card
# against f32 on the CPU on the same latent (fixed before the first run);
# the text-diffuser eps call takes EPS_MIN_COS and EPS_MAX_REL_L2
LOGITS_MIN_COS = 0.995
TEXT_PROMPT = "a red cat"
# GN+SiLU+int8 against its plain version: a code may differ by one where
# y / s lies within f32 rounding of a half-integer (other summation order
# of the statistics, y / (1 + exp(-y)) against y * sigmoid(y))
GNQ_MAX_OFF_BY_ONE = 1e-3
# gn_stats against its plain version (f32 sums in another order): relative
GNQ_STATS_RTOL = 1e-4
# main_f32's eps call, f32 on the card against f32 on the CPU on the same
# weights and inputs (fixed before the first run). With the card's default
# flags cuDNN runs f32 convolutions in TF32, which rounds 8 times finer than
# bf16 (10 mantissa bits to 7), and bf16 eps calls read relative L2
# 0.011-0.018 against f32 (main_legacy's calls): about 0.002 is expected,
# 0.005 is the bound. With TF32 off both sides are f32 (the flash sites on
# the tf32x3 kernel, ~1e-6 from f32) and differ in summation order only
F32_EPS_MIN_COS, F32_EPS_MAX_REL_L2 = 0.9999, 0.005
F32_EPS_NO_TF32_MAX_REL_L2 = 1e-4
# the flash kernels' f32 route against their plain versions in f32 (TF32
# off): |k - p| <= F32_ATOL + F32_RTOL * |p|, the CPU f32 flash band (both
# sides sum f32 products in other orders), and relative L2 <= F32_MAX_REL_L2
F32_ATOL, F32_RTOL, F32_MAX_REL_L2 = 2e-5, 1e-4, 1e-5
# the wide tf32x3 forward's lse (heads over 80) against the plain one's: the
# 128-row kernel's largest error at the main path's shapes (1.14e-5 at 4096
# keys on an H100, inside the F32_ATOL / F32_RTOL band that gates it)
F32_LSE_ATOL = 1.1e-5
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
# main_launch: the launcher's run (vd_laion_t2i cut to LAUNCH_ITERS steps of
# global batch LAUNCH_BATCH) on LAUNCH_SHARDS PNG shards of LAUNCH_PER_SHARD
# samples, LAUNCH_OTHER of them at another size; the latent cache of
# LAUNCH_CACHE batches encoded in chunks of LAUNCH_CHUNK; the resume to
# LAUNCH_RESUME_ITERS; a rerun from iter_2 held within LAUNCH_RESUME_BOUND
# times the lr sum of its two steps of the first run (Adam moves an element
# by about lr a step; fixed before the first run)
LAUNCH_DIR = os.path.join("build", "main_launch")
LAUNCH_SHARDS, LAUNCH_PER_SHARD, LAUNCH_OTHER = 2, 24, 4
LAUNCH_BATCH, LAUNCH_CACHE, LAUNCH_CHUNK = 8, 3, 4
LAUNCH_ITERS, LAUNCH_RESUME_ITERS = 4, 6
LAUNCH_RESUME_BOUND = 2.5
# the launcher's run (b)-(d) is cut in depth, not width: three levels
# (320 / 640 / 1280 channels, the 64^2, 32^2 and 16^2 maps) with one block
# a level in both diffusers, set through the experiment's model_args. A
# call may write 45 GiB to the machine's disk, deleted files included; a
# full-depth checkpoint (parameters, Adam's moments, the EMA) is 23.8 GB and
# the run writes three, this cut 10.7 GB with bf16 first moments. (e)-(h)
# write nothing and run at the same three levels since main_parallel joined
# the default run (the whole run must end within 1200 s): every path they
# hold (the text flow, the CLIP tower in the loss, bf16 master weights, the
# f32 route at the 4096- and 1024-token sites) is there at three levels.
LAUNCH_LEVELS = {"image": {"num_res_blocks": [1, 1, 1], "channel_mult": [1, 2, 4],
                           "attention_resolutions": [4, 2, 1]},
                 "text": {"num_noattn_blocks": [1, 1, 1], "channel_mult": [1, 2, 4],
                          "second_dim": [4, 4, 4], "with_attn": [True, True, True]}}
# main_parallel: every sample of its PAR_SHARDS shards is one seeded 512^2 PNG
# and one caption, so the global batch of dp = 2 (each rank its own shard)
# holds what one process's does, and (b) is held to (a) step by step. The
# bounds were fixed before the first run: the losses of dp = 2 (the mean of
# the ranks' means) within PAR_LOSS_RTOL of one process's (bf16 compute at
# micro-batch 2 against 4: the libraries take other shapes); a tp = 2 eps
# call's model output ([uncond; cond]) against one process within
# PAR_EPS_MIN_COS / PAR_EPS_MAX_REL_L2. The guided eps (uncond + 7.5 (cond -
# uncond)) multiplies bf16 rounding by up to the scale: on an H100 it read
# cosine 0.990498, relative L2 0.138 there against one process,
# while the CPU's f32 and bf16 runs agree bit for bit; so it is held to
# f32 on the same weights, at most PAR_EPS_F32_RATIO times one process's
# own distance to f32
PAR_DIR = os.path.join("build", "main_parallel")
PAR_SHARDS, PAR_PER_SHARD, PAR_ITERS, PAR_CACHE = 2, 12, 2, 1
# (c) runs at main_launch's three levels, one dry run for the eps call and
# the training, batch 2 in one micro-batch: every sharded layer gathers its
# output and sums its input gradient through the host (gloo), ~19 s a
# training step at batch 4 in two micro-batches on an H100, and the full
# depth's separate eps run cost ~50 s of a default run near its time limit
PAR_TP_BATCH = 2
PAR_LOSS_RTOL = 1e-2
PAR_EPS_MIN_COS, PAR_EPS_MAX_REL_L2, PAR_EPS_F32_RATIO = 0.999, 0.02, 1.5
PAR_TIMEOUT = 420     # seconds for each multi-process run, every rank killed after
# intra-op threads of eps_int8's CPU call while main_parallel's ranks run
PAR_CPU_THREADS = 4
TOME_RATIO = 0.75
SEED = 0      # weights, noise and inputs are made from it
STEPS = 50    # DDIM steps of the main-path request
# the requests of main_i2i, main_text, main_mcg, main_modes, main_int8, modes,
# main_fused2 and main_queue (a) run once: their warm repeats and
# main_modes' timing rounds
# are the port's benchmark's to time (ROADMAP queue 1 item 1). main keeps
# cold and warm: its warm seconds are the host's pace.
ONCE = ("once",)
# main_modes: DPM-Solver++(2M) steps, the encoder-reuse interval (warmup 5,
# the JAX package's default), the cfg interval of request (c); the split
# walk and cfg_interval=(0, 1) against the full walk and plain CFG, in
# relative L2 (the same kernels on the same inputs; bit-equal expected)
MODE_STEPS = 20
MODE_REUSE = 2
MODE_BAND = (0.1, 0.8)
MODE_MAX_REL_L2 = 1e-3
# main_queue: the serving queue's buckets; its full bucket of 8 t2i requests
# (UNet batch 16) at DDIM-50; the co-rider, bucket-1 and seven-flow checks at
# QUEUE_STEPS; the CLI at CLI_STEPS
QUEUE_BUCKETS = (1, 2, 4, 8)
QUEUE_STEPS = 10
CLI_STEPS = 4
QUEUE_PROMPTS = ("a red cat sitting on a wooden bench in the sun",
                 "a lighthouse on a cliff at dawn", "a bowl of ramen, studio photo",
                 "an astronaut riding a horse", "a watercolor of a fox in the snow",
                 "a city street at night in the rain", "a vintage car by the sea",
                 "a mountain lake with pine trees")
# bucket 1 against bucket 8 (bf16, 50 steps): other batch shapes take other
# kernels' and libraries' orders of work; the port's fixed full-width
# sanity gate
QUEUE_MAX_REL_L2, QUEUE_MIN_COS = 0.10, 0.995
# ToMe's merge timed at the UNet's 64^2 sites: the CFG batch of 2 images and
# the queue's full bucket
# main_quality: the VAE loss at KL-f8's training resolution, its card
# against CPU bound on the loss terms (f32 both, TF32 off: cuDNN against
# oneDNN summation order through two conv stacks; the largest term's
# difference read 2.726e-7 on an H100 80GB HBM3 at 700 W, so 1e-5 is ~37x
# that), the calibration statistic swept beside "none", the phase's time
# budget
QUALITY_LOSS_BATCH = 2
QUALITY_LOSS_RTOL = 1e-5
# the adaptive weight's unclipped ratio: the adversarial gradient at the
# decoder's last kernel is ~1e-6 of the NLL's and goes back through the
# discriminator's convs, whose cuDNN backward sums in another order than
# oneDNN's (6.3e-4 read on an H100 80GB HBM3 at 700 W)
QUALITY_GRAD_RTOL = 1e-2
QUALITY_SWEEP = "q99.9"
QUALITY_SECONDS = 150
TOME_SHAPES = [(4, 4096, 320), (16, 4096, 320)]
TOME_RUNS = 20
# main_legacy: the legacy diffuser zoo (vdtpu_torch/models/legacy.py) at
# published widths, nothing downloaded. VD v1's two trunks are
# openai_unet_2d_v1's and openai_unet_0d_v1's args less ``parts``
# (vdtpu/config/configs/openai_unet.yaml; ``_legacy_vd_cfg``). SD v1 is CompVis
# configs/stable-diffusion/v1-inference.yaml's unet_config. ADM is
# openai/guided-diffusion's README flags for the ImageNet 256x256
# class-conditional model (--attention_resolutions 32,16,8 --class_cond True
# --image_size 256 --learn_sigma True --num_channels 256
# --num_head_channels 64 --num_res_blocks 2 --resblock_updown True
# --use_fp16 True --use_scale_shift_norm True; channel_mult (1, 1, 2, 2, 4,
# 4) for 256^2 in its script_util.py; 32,16,8 are resolutions, ds 8, 16, 32).
# Each bf16 eps call is held to the same module in f32 on the card (TF32
# off) at EPS_MIN_COS / EPS_MAX_REL_L2, fixed before the first run
LEGACY_SD_V1 = dict(image_size=32, in_channels=4, out_channels=4, model_channels=320,
                    attention_resolutions=[4, 2, 1], num_res_blocks=2, channel_mult=[1, 2, 4, 4],
                    num_heads=8, use_spatial_transformer=True, transformer_depth=1,
                    context_dim=768, use_checkpoint=True, legacy=False)
LEGACY_ADM_256 = dict(image_size=256, in_channels=3, model_channels=256, out_channels=6,
                      num_res_blocks=2, attention_resolutions=[8, 16, 32], dropout=0.0,
                      channel_mult=[1, 1, 2, 2, 4, 4], num_classes=1000, use_checkpoint=False,
                      use_fp16=True, num_heads=4, num_head_channels=64, num_heads_upsample=-1,
                      use_scale_shift_norm=True, resblock_updown=True,
                      use_new_attention_order=False)
LEGACY_DC_RATIO = 0.3    # the dual-context blend and forward_dc's mixed ratio
LEGACY_BATCH = 2         # (b)'s eps calls: the CFG batch of one image
# the dual-context family's branches (which_attn 1, the blend) against
# branch 0: random weights give another output (relative L2 ~0.9 read on
# an H100), so a selection that changed nothing reads far below this
LEGACY_DC_APART = 0.05

_LOG = None
# vdtpu_torch.utils.timing.time_graph_ms, bound in main() once the port imports
time_graph_ms = None


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


def compare(out, ref, atol: float = ATOL, rtol: float = RTOL):
    """(max abs err, relative L2 err, within tolerance) of two tensors, in f32."""
    import torch
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool((err <= atol + rtol * b.abs()).all())
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
    from vdtpu_torch.ops.probes import probe_scratch, probe_shift
    t0 = time.perf_counter()
    build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in build.build_logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) > 0 for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  nvcc {name}: {build.build_seconds.get(name, 0.0):.1f} s, {len(regs)} kernels, "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}, {spills} with spills")
        # ptxas -v of the setmaxnreg kernels, whose launch needs an exact count
        wg = []
        for fn, n in re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                                text, re.S):
            base = re.search(r"\d+([a-z_]+_wg_kernel)", fn)
            if base:
                args = re.findall(r"Li(\d+)E", fn) + re.findall(r"ModeE(\d)", fn)
                wg.append(f"{base.group(1)}<{','.join(args)}>:{n}")
        if wg:
            log(f"  nvcc {name} registers: {' '.join(wg)}")
    x = torch.randn(2, 64, 4, 4, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    gn_silu(x, w, w, 32, 1e-5, True)  # the CUDA kernels' first launches; then the Triton ones
    gn_silu_q(x, w, w, torch.ones((), device="cuda"), 32, 1e-5, True)
    gn_stats(x, 32, 1e-5)
    probe_shift(torch.zeros((4, 4), dtype=torch.int32, device="cuda"))
    probe_scratch(torch.zeros((4, 4), dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    state["build_s"] = time.perf_counter() - t0
    state["nvcc_s"] = dict(build.build_seconds)
    log(f"build: nvcc {t_nvcc:.2f} s, with triton {state['build_s']:.2f} s")


def _attention_case(shape, gen, nomax: bool = False):
    """The flash kernel, or the no-max kernel with the true per-head max
    logit as its shift, against its plain version and SDPA; on the path
    ``attn_fwd_plan`` gives, which must be the wgmma kernel's at the main
    path's shapes and the mma.sync kernel's at ``*_MMA_SHAPES``."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import (
        ATTN_WG_MAX_D, _plan_for, flash_attention, flash_attention_plain)
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    b, n, h, d = shape[:4]
    offset = shape[4] if len(shape) > 4 else 0
    m = shape[5] if len(shape) > 5 else n
    want = "mma" if shape in FLASH_MMA_SHAPES + NOMAX_MMA_SHAPES or d > ATTN_WG_MAX_D else "wgmma"
    q, k, v = (torch.randn(b * rows * h * d + offset, device="cuda", generator=gen)
               .to(torch.bfloat16)[offset:].view(b, rows, h, d) for rows in (n, m, m))
    if nomax:
        shift = _true_shift(q, k, d ** -0.5)
        fn = flash_attention_nomax
        kern = lambda: flash_attention_nomax(q, k, v, shift)
        plain = lambda: flash_attention_nomax_plain(q, k, v, shift)
    else:
        fn = flash_attention
        kern = lambda: flash_attention(q, k, v)
        plain = lambda: flash_attention_plain(q, k, v)
    before = dict(fn.launches_by_path)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    took = [p for p, c in fn.launches_by_path.items() if c != before[p]]
    path = _plan_for(q, k, v).path
    err, rel, ok = compare(out, ref)
    ok = ok and rel <= ATTN_MAX_REL_L2 and took == [path] and path == want
    extra = {"path": path, "offset": offset, "keys": m}
    if not nomax:  # the lse output (training's forward) and its time
        from vdtpu_torch.ops.flash import flash_attention_fwd
        kern_lse = lambda: flash_attention_fwd(q, k, v, d ** -0.5, with_lse=True)
        (out_l, lse), (_, lse_ref) = kern_lse(), flash_attention_plain(q, k, v, with_lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        _, rel_l, ok_l = compare(out_l, ref)
        ok = ok and ok_l and rel_l <= ATTN_MAX_REL_L2 and lse_err <= LSE_ATOL
        extra.update(lse_max_abs_err=lse_err, ms_with_lse=time_graph_ms(kern_lse))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=time_ms(lib, 20))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2), time_graph_ms(lib)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops, exps = 4.0 * b * h * n * m * d, float(b * h * n * m)
    bound_ms, bound_by = _bound(nbytes, max(flops / PEAK_BF16, exps / PEAK_EXP))
    return dict(shape=[b, n, h, d], max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library="F.scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by, eager=eager,
                bound_detail=dict(bytes=nbytes, flops=flops, exps=exps), **extra)


def _attention_qkv_case(shape, gen):
    """The flash forward on the legacy AttentionBlock's q, k and v: strided
    views of one fused qkv projection [B, N, 3 * H * d], split heads-first
    ([B, N, H, 3, d], legacy order) or q/k/v-first ([B, N, 3, H, d], new
    order), against its plain version on the same views and SDPA on their
    [B, H, N, d] transposes; the path ``attn_fwd_plan`` takes from their
    pointers and strides (no copy is made to reach a kernel)."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import _plan_for, flash_attention, flash_attention_plain
    b, n, h, d, order = shape
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(torch.bfloat16)
    if order == "new":
        v5 = qkv.view(b, n, 3, h, d)
        q, k, v = v5[:, :, 0], v5[:, :, 1], v5[:, :, 2]
    else:
        v5 = qkv.view(b, n, h, 3, d)
        q, k, v = v5[..., 0, :], v5[..., 1, :], v5[..., 2, :]
    kern = lambda: flash_attention(q, k, v)
    plain = lambda: flash_attention_plain(q, k, v)
    before = dict(flash_attention.launches_by_path)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    took = [p for p, c in flash_attention.launches_by_path.items() if c != before[p]]
    path = _plan_for(q, k, v).path
    err, rel, ok = compare(out, ref)
    ok = ok and rel <= ATTN_MAX_REL_L2 and took == [path] and not q.is_contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=time_ms(lib, 20))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2), time_graph_ms(lib)
    nbytes = 2 * 4 * b * n * h * d      # q, k, v read once, out written once, bf16
    flops, exps = 4.0 * b * h * n * n * d, float(b * h * n * n)
    bound_ms, bound_by = _bound(nbytes, max(flops / PEAK_BF16, exps / PEAK_EXP))
    return dict(shape=[b, n, h, d], qkv_order=order, strides=list(q.stride()),
                max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library="F.scaled_dot_product_attention (on the views)",
                bound_ms=bound_ms, bound_by=bound_by, eager=eager, path=path,
                bound_detail=dict(bytes=nbytes, flops=flops, exps=exps))


def _mma_fwd(q, k, v, out):
    """A call of the flash forward's mma.sync kernel (16-byte cp.async
    loads) through its own C entry (``vd_flash_fwd_mma``), bypassing the
    plan: the kernel that heads of 88-160 took before the wgmma kernel's
    wide heads. Counts on no wrapper."""
    import ctypes
    import torch
    from vdtpu_torch.ops.flash import _flash_lib
    fn = _flash_lib("flash_fwd").vd_flash_fwd_mma
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, n, h, d = q.shape
    st = lambda t: tuple(t.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, n, k.shape[1], h,
            d, *st(q), *st(k), *st(v), *st(out), d ** -0.5, 1)

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_fwd mma.sync launch failed: cudaError {rc}")
    return call


def _wide_case(shape, gen):
    """The wgmma forward at a head of 88-160 (csrc/attn_fwd_wide.cu):
    ``_attention_case`` for Flash (with its FlashLse check) and for NoMax,
    each on the wgmma path, one launch each on ``launches_wide``; the
    mma.sync kernel it replaced on the same q, k, v (``_mma_fwd``, held to
    the plain version too) timed in turns (wgmma, mma.sync, wgmma,
    mma.sync)."""
    import torch
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
    from vdtpu_torch.ops.nomax import flash_attention_nomax
    before = (flash_attention.launches_wide["wgmma"],
              flash_attention_nomax.launches_wide["wgmma"])
    r = _attention_case(shape, gen)
    rn = _attention_case(shape, gen, nomax=True)
    wide = (flash_attention.launches_wide["wgmma"] - before[0],
            flash_attention_nomax.launches_wide["wgmma"] - before[1])
    b, n, h, d = shape[:4]
    m = shape[5] if len(shape) > 5 else n
    q, k, v = (torch.randn(b, rows, h, d, device="cuda", generator=gen).to(torch.bfloat16)
               for rows in (n, m, m))
    kern = lambda: flash_attention(q, k, v)
    mma_out = torch.empty_like(q)
    mma = _mma_fwd(q, k, v, mma_out)
    mma()
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    m_err, m_rel, m_ok = compare(mma_out, ref)
    turns = [time_graph_ms(kern), time_graph_ms(mma), time_graph_ms(kern), time_graph_ms(mma)]
    r.update(ok=r["ok"] and rn["ok"] and m_ok and m_rel <= ATTN_MAX_REL_L2 and wide[0] >= 2
             and wide[1] >= 1,
             max_abs_err=max(r["max_abs_err"], rn["max_abs_err"]), ms_turns=turns,
             mma_ms=turns[1], mma_max_abs_err=m_err, mma_rel_l2_err=m_rel,
             launches_wide=list(wide),
             nomax=dict(ms=rn["ms"], plain_ms=rn["plain_ms"], library_ms=rn["library_ms"],
                        max_abs_err=rn["max_abs_err"], rel_l2_err=rn["rel_l2_err"],
                        ok=rn["ok"], path=rn["path"], bound_ms=rn["bound_ms"]))
    return r


def _flash_fwd_case(shape, gen):
    """``_attention_qkv_case`` at FLASH_QKV_SHAPES, else ``_attention_case``."""
    if isinstance(shape[-1], str):
        return _attention_qkv_case(shape, gen)
    return _attention_case(shape, gen)


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
    # SDPA's backward alone is not one call: its device time is the graph
    # replay of forward + backward less that of the forward (the eager
    # difference, kept beside it, carries autograd's host time)
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=time_ms(lib_fb, 20) - time_ms(lib_f, 20))
    ms, plain_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2)
    lib_ms = time_graph_ms(lib_fb) - time_graph_ms(lib_f)
    prod = 2.0 * b * h * n * n * d             # one q.k^T-sized product
    exps = float(b * h * n * n)
    nbytes = 8 * q.numel() * q.element_size() + lse.numel() * lse.element_size()
    bound_ms, bound_by = _bound(nbytes, max(5 * prod / PEAK_BF16, exps / PEAK_EXP))
    return dict(shape=list(shape), max_abs_err=err, rel_l2_err=rel, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                library="F.scaled_dot_product_attention backward (graphed fwd+bwd minus fwd)",
                bound_ms=bound_ms, bound_by=bound_by, eager=eager,
                bound_detail=dict(bytes=nbytes, flops=5 * prod, exps=exps))


def _simt_f32(name: str, *tensors, scale: float):
    """A call of the f32 route's SIMT kernel through its own C
    entry (``vd_flash_fwd_f32`` / ``vd_flash_bwd_f32``), bypassing the plan,
    on contiguous f32 tensors: (call, outputs). Forward: (q, k, v, out,
    lse or None); backward: (q, k, v, dO, lse, delta, dq, dk, dv). These
    launches count on no wrapper: they are timed and checked beside the
    plan's kernels, not run by any main path."""
    import torch
    from vdtpu_torch.ops.flash import _flash_lib
    lib = _flash_lib("flash_fwd_f32" if name == "flash_fwd" else name)
    b, n, h, d = tensors[0].shape
    m = tensors[1].shape[1]
    st = lambda t: tuple(t.stride()[:3])
    ptr = lambda t: None if t is None else t.data_ptr()
    if name == "flash_fwd":
        q, k, v, out, lse = tensors
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), b, n, m, h, d, *st(q), *st(k),
                *st(v), *st(out), scale)
        fn, outs = lib.vd_flash_fwd_f32, (out, lse)
    else:
        q, k, v, do, lse, delta, dq, dk, dv = tensors
        args = (*(ptr(t) for t in tensors), b, n, m, h, d, *st(q), *st(k), *st(v), *st(do),
                *st(dq), *st(dk), *st(dv), scale)
        fn, outs = lib.vd_flash_bwd_f32, (dq, dk, dv)

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} SIMT f32 launch failed: cudaError {rc}")
    return call, outs


def _flash_f32_case(shape, gen):
    """The flash forward's f32 route at ``shape`` ((B, N, H, D) or (B, N,
    H, D, keys)), with and without lse, against the plain forward in f32
    (TF32 off): the tf32x3 kernel (the plan's path here, asserted) and,
    through its own C entry, the SIMT kernel (``_simt_f32``), both within
    F32_ATOL / F32_RTOL / F32_MAX_REL_L2 (lse within F32_LSE_ATOL); timed in
    turns (tf32x3, SIMT, tf32x3, SIMT) with SDPA in f32 as the yardstick.
    ``bound_ms``: the 3xTF32 bound (three tf32 passes of both products at
    PEAK_TF32, the exponentials, the bytes); ``bound_f32_ms``: the same
    work as f32 FMAs at PEAK_F32."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import TF32X3_BWD_MAX_D, _plan_for, flash_attention, \
        flash_attention_fwd, flash_attention_plain
    b, n, h, d = shape[:4]
    m = shape[4] if len(shape) > 4 else n
    q, k, v = (torch.randn(b, rows, h, d, device="cuda", generator=gen) for rows in (n, m, m))
    with _no_tf32():
        before = dict(flash_attention.launches_by_path)
        kern = lambda: flash_attention(q, k, v)
        kern_lse = lambda: flash_attention_fwd(q, k, v, d ** -0.5, with_lse=True)
        plain = lambda: flash_attention_plain(q, k, v)
        out, (out_l, lse) = kern(), kern_lse()
        ref, lse_ref = flash_attention_plain(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        took = {p: c - before[p] for p, c in flash_attention.launches_by_path.items()
                if c != before[p]}
        path = _plan_for(q, k, v).path
        err, rel, ok = compare(out, ref, F32_ATOL, F32_RTOL)
        err_l, rel_l, ok_l = compare(out_l, ref, F32_ATOL, F32_RTOL)
        lse_err, _, ok_lse = compare(lse, lse_ref, F32_ATOL, F32_RTOL)
        ok = (ok and ok_l and ok_lse and max(rel, rel_l) <= F32_MAX_REL_L2
              and (d <= TF32X3_BWD_MAX_D or lse_err <= F32_LSE_ATOL)
              and path == "tf32x3" and took == {"tf32x3": 2})
        simt, (s_out, _) = _simt_f32("flash_fwd", q, k, v, torch.empty_like(q), None,
                                     scale=d ** -0.5)
        simt_lse, (_, s_lse) = _simt_f32("flash_fwd", q, k, v, torch.empty_like(q),
                                         torch.empty_like(lse), scale=d ** -0.5)
        simt()
        simt_lse()
        s_err, s_rel, s_ok = compare(s_out, ref, F32_ATOL, F32_RTOL)
        s_ok = s_ok and s_rel <= F32_MAX_REL_L2 and compare(s_lse, lse_ref, F32_ATOL, F32_RTOL)[2]
        del out, out_l, lse, ref, lse_ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        eager = dict(ms=time_ms(kern, 5), plain_ms=time_ms(plain, 3, warmup=1),
                     library_ms=time_ms(lib, 5), simt_ms=time_ms(simt, 3, warmup=1))
        turns = [time_graph_ms(kern), time_graph_ms(simt), time_graph_ms(kern),
                 time_graph_ms(simt)]
        plain_ms, lib_ms = time_graph_ms(plain, 2, 2), time_graph_ms(lib)
        ms_lse, simt_ms_lse = time_graph_ms(kern_lse), time_graph_ms(simt_lse)
    flops, exps = 4.0 * b * h * n * m * d, float(b * h * n * m)
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    bound_ms, bound_by = _bound(nbytes, max(3 * flops / PEAK_TF32, exps / PEAK_EXP))
    bound_f32_ms, _ = _bound(nbytes, max(flops / PEAK_F32, exps / PEAK_EXP))
    return dict(shape=list(shape), max_abs_err=max(err, err_l), rel_l2_err=max(rel, rel_l),
                ok=ok and s_ok, ms=turns[0], ms_turns=turns, plain_ms=plain_ms,
                library_ms=lib_ms, library="F.scaled_dot_product_attention (f32)",
                bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms, eager=eager,
                path=path, lse_max_abs_err=lse_err, ms_with_lse=ms_lse, simt_ms=turns[1],
                simt_ms_with_lse=simt_ms_lse, simt_max_abs_err=s_err, simt_rel_l2_err=s_rel,
                simt_ok=s_ok, bound_detail=dict(bytes=nbytes, flops=flops, exps=exps,
                                                tf32_passes=3))


def _flash_bwd_f32_case(shape, gen):
    """The flash backward's f32 route at ``shape`` against the plain
    backward in f32 (TF32 off) on the same (q, k, v, o, lse, dO): the
    tf32x3 kernels (the plan's path here, asserted) and, through its own C
    entry, the SIMT kernels, both within the f32 gate and bit-equal
    across two runs; timed in turns with SDPA's f32 backward as the
    yardstick. Bounds as ``_flash_f32_case``'s over the 5 products of one
    pass (the kernels keep the TPU's split and take 7)."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.flash import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain)
    b, n, h, d = shape
    scale = d ** -0.5
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen) for _ in range(4))
    with _no_tf32():
        o, lse = flash_attention_plain(q, k, v, with_lse=True)
        kern = lambda: flash_attention_bwd(q, k, v, o, lse, do, scale)
        plain = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        before = dict(flash_attention_bwd.launches_by_path)
        outs, again, refs = kern(), kern(), plain()
        torch.cuda.synchronize()
        took = {p: c - before[p] for p, c in flash_attention_bwd.launches_by_path.items()
                if c != before[p]}
        err = rel = 0.0
        bit_equal = all(torch.equal(a, r) for a, r in zip(outs, again))
        ok = took == {"tf32x3": 2} and bit_equal
        for a, r in zip(outs, refs):
            e, rl, ok_a = compare(a, r, F32_ATOL, F32_RTOL)
            err, rel, ok = max(err, e), max(rel, rl), ok and ok_a
        ok = ok and rel <= F32_MAX_REL_L2
        delta = (do * o).sum(dim=-1).transpose(1, 2).contiguous()
        grads = [torch.empty_like(t) for t in (q, k, v)]
        simt, s_outs = _simt_f32("flash_bwd", q, k, v, do, lse, delta, *grads, scale=scale)
        simt()
        s_first = [t.clone() for t in s_outs]
        simt()
        s_err = s_rel = 0.0
        s_ok = all(torch.equal(a, r) for a, r in zip(s_first, s_outs))
        for a, r in zip(s_outs, refs):
            e, rl, ok_a = compare(a, r, F32_ATOL, F32_RTOL)
            s_err, s_rel, s_ok = max(s_err, e), max(s_rel, rl), s_ok and ok_a
        s_ok = s_ok and s_rel <= F32_MAX_REL_L2
        del outs, again, refs, s_first
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)
        lib_f = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        lib_fb = lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt),
                                             (qt, kt, vt), dot)
        eager = dict(ms=time_ms(kern, 3, warmup=1), plain_ms=time_ms(plain, 3, warmup=1),
                     library_ms=time_ms(lib_fb, 5) - time_ms(lib_f, 5),
                     simt_ms=time_ms(simt, 3, warmup=1))
        turns = [time_graph_ms(kern), time_graph_ms(simt, 3, 2), time_graph_ms(kern),
                 time_graph_ms(simt, 3, 2)]
        plain_ms = time_graph_ms(plain, 2, 2)
        lib_ms = time_graph_ms(lib_fb) - time_graph_ms(lib_f)
    prod = 2.0 * b * h * n * n * d
    exps = float(b * h * n * n)
    nbytes = 4 * (8 * q.numel() + 2 * lse.numel())
    bound_ms, bound_by = _bound(nbytes, max(3 * 5 * prod / PEAK_TF32, exps / PEAK_EXP))
    bound_f32_ms, _ = _bound(nbytes, max(5 * prod / PEAK_F32, exps / PEAK_EXP))
    return dict(shape=list(shape), max_abs_err=err, rel_l2_err=rel, ok=ok and s_ok,
                ms=turns[0], ms_turns=turns, plain_ms=plain_ms, library_ms=lib_ms,
                path="tf32x3", simt_ms=turns[1], simt_max_abs_err=s_err, simt_rel_l2_err=s_rel,
                simt_ok=s_ok, bit_equal=bit_equal,
                library="F.scaled_dot_product_attention backward, f32 (graphed fwd+bwd minus fwd)",
                bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms, eager=eager,
                bound_detail=dict(bytes=nbytes, flops=5 * prod, exps=exps, tf32_passes=3))


@contextlib.contextmanager
def _no_tf32():
    """Full f32 matmuls and convolutions (the plain versions' reference)."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _gn_case(shape, gen):
    """The GN kernel against its plain version, with and without SiLU; the
    launch must take the route ``GN_ROUTES`` names (``gn_plan``'s), once,
    and give the same bits twice."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_plan, gn_silu, gn_silu_plain
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    bias = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    plan = gn_plan(tuple(shape), torch.bfloat16, 32)
    worst = (0.0, 0.0, plan.route == GN_ROUTES[tuple(shape)])
    for silu in (True, False):
        by_path = dict(gn_silu.launches_by_path)
        out = gn_silu(x, w, bias, 32, 1e-6, silu)
        took = {k: v - by_path[k] for k, v in gn_silu.launches_by_path.items() if v != by_path[k]}
        err, rel, ok = compare(out, gn_silu_plain(x, w, bias, 32, 1e-6, silu))
        ok = ok and took == {plan.route: 1} and torch.equal(out, gn_silu(x, w, bias, 32, 1e-6,
                                                                         silu))
        worst = (max(worst[0], err), max(worst[1], rel), worst[2] and ok)
    iters = 50 if x.numel() < 1 << 24 else 10
    silu = tuple(shape) not in GN_NO_SILU
    kern = lambda: gn_silu(x, w, bias, 32, 1e-5, silu)
    plain = lambda: gn_silu_plain(x, w, bias, 32, 1e-5, silu)
    lib = ((lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-5))) if silu else
           (lambda: F.group_norm(x, 32, w, bias, 1e-5)))
    eager = dict(ms=time_ms(kern, iters), plain_ms=time_ms(plain, iters),
                 library_ms=time_ms(lib, iters))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain), time_graph_ms(lib)
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * w.element_size()
    flops = 12.0 * x.numel()
    bound_ms, bound_by = _bound(nbytes, flops / PEAK_F32)
    return dict(shape=list(shape), route=plan.route, layout=plan.layout, cluster=plan.cluster,
                ctas=plan.ctas, threads=plan.threads, smem_bytes=plan.smem_bytes,
                max_abs_err=worst[0], rel_l2_err=worst[1], ok=worst[2], timed_with_silu=silu,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.group_norm + F.silu (two calls)" if silu else "F.group_norm (one call)",
                bound_ms=bound_ms,
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


def _gnq_want(shape, stats: bool) -> str:
    """The route gnq_plan must give: gn_silu_q the streaming route at the
    int8 GN sites and the general route at GNQ_ODD_SHAPES; gn_stats the
    group route at the sites and at conv_in's 4 channels, else the general
    route."""
    if stats:
        return "group" if shape in GNQ_SHAPES or shape == (4, 4, 64, 64) else "general"
    return "general" if shape in GNQ_ODD_SHAPES else "streaming"


def _gnq_agree(out, ref, stats: bool):
    """(max abs err, off-by-one share of the codes or the statistics'
    relative error, within the gate): codes within one of the plain
    version's and at most GNQ_MAX_OFF_BY_ONE of them off; statistics within
    GNQ_STATS_RTOL."""
    import torch
    if stats:
        err = float(((out - ref).abs() / ref.abs().clamp_min(1e-6)).max())
        return float((out - ref).abs().max()), err, bool(torch.isfinite(out).all()) and \
            err <= GNQ_STATS_RTOL
    diff = (out.int() - ref.int()).abs()
    off = float((diff > 0).float().mean())
    return float(diff.max()), off, int(diff.max()) <= 1 and off <= GNQ_MAX_OFF_BY_ONE


def _gnq_case(shape, gen, stats: bool = False):
    """gn_silu_q (``stats``: gn_stats) against its plain version, with and
    without SiLU; one launch a call on the route ``_gnq_want`` names
    (``launches_by_route``), the same bits twice; device (graph) and eager
    ms of the kernel, the plain version and the yardstick (GN+SiLU and the
    quantize ops, several calls; torch.var_mean over the groups, one call)."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import (gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain,
                                         gnq_plan)
    from vdtpu_torch.ops.qconv import sm_count
    groups = GNQ_GROUPS.get(tuple(shape), 32)
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    bias = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    s = torch.tensor(0.02, device="cuda")
    plan = gnq_plan(tuple(shape), torch.bfloat16, groups, sm_count(0), stats)
    fn = gn_stats if stats else gn_silu_q
    worst, ok = (0.0, 0.0), plan.route == _gnq_want(tuple(shape), stats)
    for silu in ((False,) if stats else (True, False)):
        if stats:
            kern = lambda: gn_stats(x, groups, 1e-5)
            plain = lambda: gn_stats_plain(x, groups, 1e-5)
        else:
            kern = lambda: gn_silu_q(x, w, bias, s, groups, 1e-5, silu)
            plain = lambda: gn_silu_q_plain(x, w, bias, s, groups, 1e-5, silu)
        by, n0 = dict(fn.launches_by_route), fn.launches
        out = kern()
        took = {k: v - by[k] for k, v in fn.launches_by_route.items() if v != by[k]}
        again = kern()
        err, off, agree = _gnq_agree(out, plain(), stats)
        torch.cuda.synchronize()
        ok = (ok and agree and took == {plan.route: 1} and fn.launches == n0 + 2
              and torch.equal(out, again))
        worst = (max(worst[0], err), max(worst[1], off))
    if not stats:   # timed as the int8 sites call it: with SiLU
        kern = lambda: gn_silu_q(x, w, bias, s, groups, 1e-5, True)
        plain = lambda: gn_silu_q_plain(x, w, bias, s, groups, 1e-5, True)
    if stats:   # one library reduction over the groups (no channel broadcast)
        lib = lambda: torch.var_mean(x.view(shape[0], groups, -1), dim=-1, correction=0)
        library = "torch.var_mean over the groups (one call)"
        nbytes = x.numel() * x.element_size() + 8 * shape[0] * c
        t_ops = 3.0 * x.numel() / PEAK_F32
    else:       # F.group_norm + F.silu + the quantize ops: several calls
        def lib():
            y = F.silu(F.group_norm(x, groups, w, bias, 1e-5)).float()
            return torch.clamp(torch.round(y * (1.0 / s)), -127, 127).to(torch.int8)
        library = "F.group_norm + F.silu + round/clamp/cast (several calls)"
        nbytes = x.numel() * (x.element_size() + 1) + 2 * c * w.element_size()
        # 14 f32 operations and two special-function ones (exp, rcp) a code
        t_ops = max(14.0 * x.numel() / PEAK_F32, 2.0 * x.numel() / PEAK_EXP)
    iters = 50 if x.numel() < 1 << 24 else 10
    eager = dict(ms=time_ms(kern, iters), plain_ms=time_ms(plain, iters),
                 library_ms=time_ms(lib, iters))
    ms, plain_ms, lib_ms = time_graph_ms(kern), time_graph_ms(plain), time_graph_ms(lib)
    bound_ms, bound_by = _bound(nbytes, t_ops)
    return dict(shape=list(shape), groups=groups, route=plan.route, cs=plan.cs,
                pixels=plan.pixels, threads=plan.threads,
                tiles=plan.tiles, ctas=plan.ctas,
                smem_bytes=plan.smem_bytes, max_abs_err=worst[0],
                **{("stats_rel_err" if stats else "off_by_one"): worst[1]}, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library=library, bound_ms=bound_ms,
                bound_by=bound_by, eager=eager, bound_detail=dict(bytes=nbytes, ops_seconds=t_ops))


def _qconv_case(spec, gen):
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_stats
    from vdtpu_torch.ops.qconv import (qconv3, qconv3_gn, qconv3_gn_plain, qconv3_plain,
                                       qconv3_plan)
    b, c, h, w, n, stride, add = spec
    plan = qconv3_plan(b, h, w, c, n, stride)
    gn_plan = qconv3_plan(b, h, w, c, n, stride, True, True, 2)   # bf16 NCHW input
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
    return dict(shape=list(spec), path=plan.path, n_tile=plan.bn, rows=plan.rows,
                tile_pixels=plan.bm, grid=list(plan.grid), smem_bytes=plan.smem_bytes,
                gn_n_tile=gn_plan.bn, gn_grid=list(gn_plan.grid), gn_rows_staged=gn_plan.raw,
                max_abs_err=max(err, err_gn), rel_l2_err=max(rel, rel_gn),
                ok=ok and ok_gn, ms=ms, gn_ms=gn_ms, plain_ms=plain_ms, gn_plain_ms=gn_plain_ms,
                library_ms=lib_ms, library="F.conv2d bf16 channels_last (cuDNN)",
                int_mm_ms=int_mm_ms, bound_ms=bound_ms, gn_bound_ms=gn_bound_ms,
                bound_by=bound_by, eager=eager, bound_detail=dict(bytes=nbytes, ops=ops))


def compare_resblock(out, ref):
    """(max abs err, relative L2 err, share outside two ulps, within bound)."""
    import torch
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    outside = float((err > ATOL + RTOL * b.abs()).float().mean())
    rel = float(err.norm() / b.norm())
    ok = bool(torch.isfinite(a).all()) and outside <= RB_MAX_OUTSIDE and rel <= RB_MAX_REL_L2
    return float(err.max()), rel, outside, ok


def _resblock_case(spec, gen):
    """The whole-ResBlock kernel against its plain version, and three
    yardsticks for the same block: the port's per-site int8 chain
    (gn_silu_q + qconv3, twice), its conv="fused" chain (gn_stats +
    qconv3_gn, twice), and cuDNN's bf16 ResBlock (F.group_norm + F.silu +
    F.conv2d, twice, and the adds). No one PyTorch call computes an int8
    ResBlock: PyTorch has no CUDA int8 convolution. The launch must take
    the route ``resblock_plan`` gives, which must be the halo route at the
    UNet's sites and the general route at ``RESBLOCK_GENERAL_SHAPES``."""
    import torch
    import torch.nn.functional as F
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_stats
    from vdtpu_torch.ops.qconv import (qconv3, qconv3_gn, resblock_plain, resblock_plan,
                                       resblock_q, sm_count)
    from vdtpu_torch.ops.quant import quantize_weight
    b, c, h, w, n = spec
    plan = resblock_plan(b, h, w, c, n, sms=sm_count(0))
    want = "general" if spec in RESBLOCK_GENERAL_SHAPES else "halo"
    rnd = lambda *sh: torch.randn(sh, device="cuda", generator=gen)
    bf = torch.bfloat16
    x = (rnd(b, c, h, w) * 2 + 0.5).to(bf)
    w1, w2 = rnd(n, c, 3, 3) * (9 * c) ** -0.5, rnd(n, n, 3, 3) * (9 * n) ** -0.5
    (w1q, s1w), (w2q, s2w) = (quantize_weight(t.permute(0, 2, 3, 1)) for t in (w1, w2))
    w1q, w2q = w1q.contiguous(), w2q.contiguous()
    g1, be1 = rnd(c) * 0.1 + 1.0, rnd(c) * 0.1
    g2, be2 = rnd(n) * 0.1 + 1.0, rnd(n) * 0.1
    b1, b2 = (rnd(n) * 0.1).to(bf), (rnd(n) * 0.1).to(bf)
    sx1, sx2 = torch.tensor(4.0 / 127, device="cuda"), torch.tensor(4.0 / 127, device="cuda")
    film = (rnd(b, n) * 0.5).to(bf)
    skip = rnd(b, n, h, w).to(bf) if c != n else None
    args = (x, g1, be1, w1q, s1w, b1, sx1, film, g2, be2, w2q, s2w, b2, sx2, skip)
    kern = lambda: resblock_q(*args)
    plain = lambda: resblock_plain(*args)
    by_path = dict(resblock_q.launches_by_path)
    out = kern()
    took = {k: v - by_path[k] for k, v in resblock_q.launches_by_path.items() if v != by_path[k]}
    err, rel, outside, ok = compare_resblock(out, plain())
    ok = ok and plan.route == want and took == {want: 1}
    ok = ok and torch.equal(out, kern())   # fixed-order sums: deterministic
    sk = x if skip is None else skip

    def per_site():
        q1 = gn_silu_q(x, g1, be1, sx1, 32, 1e-5, True)
        mid = qconv3(q1, w1q, s1w, b1, sx1, 1, film, None, bf)
        q2 = gn_silu_q(mid, g2, be2, sx2, 32, 1e-5, True)
        return qconv3(q2, w2q, s2w, b2, sx2, 1, None, sk, bf)

    def fused():
        mid = qconv3_gn(x, gn_stats(x, 32, 1e-5), g1, be1, sx1, w1q, s1w, b1, True, 1, film)
        return qconv3_gn(mid, gn_stats(mid, 32, 1e-5), g2, be2, sx2, w2q, s2w, b2, True, 1,
                         None, sk)

    w1b, w2b = w1.to(bf), w2.to(bf)
    filmb = film[:, :, None, None]

    def cudnn():
        hh = F.conv2d(F.silu(F.group_norm(x, 32, g1.to(bf), be1.to(bf), 1e-5)), w1b, b1,
                      padding=1) + filmb
        return F.conv2d(F.silu(F.group_norm(hh, 32, g2.to(bf), be2.to(bf), 1e-5)), w2b, b2,
                        padding=1) + sk

    torch.cuda.synchronize()
    eager = dict(ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3, warmup=1),
                 per_site_ms=time_ms(per_site, 20), fused_ms=time_ms(fused, 20),
                 cudnn_bf16_ms=time_ms(cudnn, 20))
    timing = "CUDA graph replay"
    try:
        ms = time_graph_ms(kern)
    except RuntimeError as exc:   # stream capture of the cooperative launch refused
        ms, timing = eager["ms"], f"eager CUDA events (graph capture refused: {exc})"
    plain_ms = time_graph_ms(plain, 2, 2)
    per_site_ms, fused_ms, cudnn_ms = (time_graph_ms(f) for f in (per_site, fused, cudnn))
    ops = 2.0 * b * h * w * 9 * (c * n + n * n)
    nbytes = 2 * (x.numel() + (0 if skip is None else skip.numel()) + out.numel()) \
        + w1q.numel() + w2q.numel()
    bound_ms, bound_by = _bound(nbytes, ops / PEAK_INT8)
    return dict(shape=list(spec), route=plan.route, tile_pixels=plan.bm, n_tile=plan.bn,
                rows=plan.rows, grid=plan.grid, conv_tiles=plan.conv_tiles,
                wave_fill=round(plan.fill, 4), barriers=plan.barriers,
                smem_bytes=plan.smem_bytes, max_abs_err=err, rel_l2_err=rel,
                outside_share=outside, ok=ok, ms=ms, timing=timing, plain_ms=plain_ms,
                library_ms=None,
                library="none: PyTorch has no CUDA int8 convolution",
                per_site_chain_ms=per_site_ms, fused_chain_ms=fused_ms,
                cudnn_bf16_resblock_ms=cudnn_ms, bound_ms=bound_ms, bound_by=bound_by,
                eager=eager, bound_detail=dict(bytes=nbytes, ops=ops))


def _exact_case(kern, plain, lib, nbytes, t_ops, shape, library):
    """A kernel whose result must equal its plain version bit for bit."""
    import torch
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((out.double() - ref.double()).abs().max())
    ok = bool(torch.equal(out, ref))
    eager = dict(ms=time_ms(kern, 50), plain_ms=time_ms(plain, 5, warmup=1))
    ms, plain_ms = time_graph_ms(kern), time_graph_ms(plain, 2, 2)
    lib_ms = None
    if lib is not None:
        eager["library_ms"] = time_ms(lib, 50)
        lib_ms = time_graph_ms(lib)
    bound_ms, bound_by = _bound(nbytes, t_ops)
    return dict(shape=list(shape), max_abs_err=err, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library=library, bound_ms=bound_ms, bound_by=bound_by,
                eager=eager, bound_detail=dict(bytes=nbytes, ops_seconds=t_ops))


def _probe_s8mm_case(shape, gen):
    """Row 12: random s8 operands (and the script's ones) against the plain
    product; torch._int_mm on the same operands (B column-major, as it
    takes it) is the yardstick, the script's Pallas-against-XLA comparison."""
    import torch
    from vdtpu_torch.ops.probes import _card_clusters, probe_s8mm, probe_s8mm_plain, s8mm_plan
    m, k, n = shape
    a = torch.randint(-128, 128, (m, k), device="cuda", generator=gen).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), device="cuda", generator=gen).to(torch.int8)
    ones_a, ones_b = torch.ones_like(a), torch.ones_like(b)
    ones_ok = bool((probe_s8mm(ones_a, ones_b) == k).all())
    b_cm = b.t().contiguous().t()
    r = _exact_case(lambda: probe_s8mm(a, b), lambda: probe_s8mm_plain(a, b),
                    lambda: torch._int_mm(a, b_cm), m * k + k * n + 4 * m * n,
                    2.0 * m * n * k / PEAK_INT8, shape,
                    "torch._int_mm (B column-major)")
    r["ok"] = r["ok"] and ones_ok
    r["script_ones_ok"] = ones_ok
    clusters = _card_clusters[a.device.index or 0]   # the card's, asked by the wrapper
    r["split"], r["clusters"] = s8mm_plan(m, n, k, clusters).split, list(clusters)
    return r


def _probe_shift_case(shape, gen):
    """Row 13: seeded int32 data (sums stay inside int32) and the script's
    arange % 7; no one PyTorch call computes the four shifted adds."""
    import torch
    from vdtpu_torch.ops.probes import probe_shift, probe_shift_plain
    m, c = shape
    x = torch.randint(-(1 << 20), 1 << 20, (m, c), device="cuda", generator=gen,
                      dtype=torch.int32)
    xs = (torch.arange(m * c, device="cuda", dtype=torch.int32) % 7).reshape(m, c)
    script_ok = bool(torch.equal(probe_shift(xs), probe_shift_plain(xs)))
    r = _exact_case(lambda: probe_shift(x), lambda: probe_shift_plain(x), None,
                    2 * 4 * m * c, 3.0 * m * c / PEAK_INT32, shape,
                    "none: no single PyTorch call")
    r["ok"] = r["ok"] and script_ok
    r["script_data_ok"] = script_ok
    return r


def _probe_scratch_case(shape, gen):
    """Row 14: bf16 values inside [-127, 127] (the range where the cast is
    a plain truncation) and the script's arange % 5."""
    import torch
    from vdtpu_torch.ops.probes import probe_scratch, probe_scratch_plain
    m, c = shape
    x = ((torch.rand((m, c), device="cuda", generator=gen) * 2 - 1) * 127).to(torch.bfloat16)
    xs = (torch.arange(m * c, device="cuda", dtype=torch.int32) % 5).reshape(m, c)
    xs = xs.to(torch.bfloat16)
    script_ok = bool(torch.equal(probe_scratch(xs), probe_scratch_plain(xs)))
    r = _exact_case(lambda: probe_scratch(x), lambda: probe_scratch_plain(x), None,
                    3 * m * c, 0.0, shape, "none: no single PyTorch call")
    r["ok"] = r["ok"] and script_ok
    r["script_data_ok"] = script_ok
    return r


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = [
        ("flash_fwd", "cuda", "vdtpu_torch/csrc/flash_fwd.cu",
         "vdtpu/ops/pallas/flash.py:40", _flash_fwd_case,
         FLASH_SHAPES + FLASH_MMA_SHAPES + FLASH_XATTN_SHAPES + FLASH_HALF_SHAPES
         + ATTN_BUCKET_SHAPES + FLASH_QKV_SHAPES),
        ("flash_bwd", "cuda", "vdtpu_torch/csrc/flash_bwd.cu",
         "vdtpu/ops/pallas/flash.py:444", _flash_bwd_case, FLASH_SHAPES),
        ("flash_fwd_tf32x3", "cuda", "vdtpu_torch/csrc/flash_fwd.cu",
         "vdtpu/ops/pallas/flash.py:40", _flash_f32_case, FLASH_SHAPES),
        ("attn_fwd_wide", "cuda", "vdtpu_torch/csrc/attn_fwd_wide.cu",
         "vdtpu/ops/pallas/flash.py:40", _wide_case, FLASH_WIDE_SHAPES),
        ("flash_fwd_tf32x3_wide", "cuda", "vdtpu_torch/csrc/tf32x3_fwd_wide.cu",
         "vdtpu/ops/pallas/flash.py:40", _flash_f32_case, FLASH_F32_WIDE_SHAPES),
        ("flash_bwd_tf32x3", "cuda", "vdtpu_torch/csrc/flash_bwd.cu",
         "vdtpu/ops/pallas/flash.py:444", _flash_bwd_f32_case, FLASH_SHAPES),
        ("gn_silu", "cuda", "vdtpu_torch/csrc/gn_silu.cu",
         "vdtpu/ops/pallas/gn_silu.py:45", _gn_case, list(GN_ROUTES)),
        ("nomax_fwd", "cuda", "vdtpu_torch/csrc/nomax_fwd.cu",
         "vdtpu/ops/pallas/flash.py:223", functools.partial(_attention_case, nomax=True),
         NOMAX_SHAPES + NOMAX_MMA_SHAPES),
        ("gn_silu_q", "cuda", "vdtpu_torch/csrc/gn_q.cu",
         "vdtpu/ops/pallas/gn_silu.py:155", _gnq_case, GNQ_SHAPES + GNQ_ODD_SHAPES),
        ("gn_stats", "cuda", "vdtpu_torch/csrc/gn_q.cu",
         "vdtpu/ops/pallas/gn_silu.py:182", functools.partial(_gnq_case, stats=True),
         GNQ_SHAPES + GNQ_ODD_SHAPES),
        ("qconv3", "cuda", "vdtpu_torch/csrc/qconv3.cu",
         "vdtpu/ops/pallas/qconv.py:149", _qconv_case, QCONV_SHAPES),
        ("resblock_q", "cuda", "vdtpu_torch/csrc/resblock_q.cu",
         "vdtpu/ops/pallas/qconv.py:235", _resblock_case,
         RESBLOCK_SHAPES + RESBLOCK_GENERAL_SHAPES),
        ("probe_s8mm", "cuda", "vdtpu_torch/csrc/probe_s8mm.cu",
         "scripts/mosaic_probe.py:35", _probe_s8mm_case, PROBE_MM_SHAPES),
        ("probe_shift", "triton", "vdtpu_torch/ops/probes.py",
         "scripts/mosaic_probe.py:81", _probe_shift_case, PROBE_SHIFT_SHAPES),
        ("probe_scratch", "triton", "vdtpu_torch/ops/probes.py",
         "scripts/mosaic_probe.py:110", _probe_scratch_case, PROBE_SCRATCH_SHAPES),
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
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"kernel {name} {shape}: max_abs_err {r['max_abs_err']:.3e} ok {r['ok']} | "
                f"device ms (graph) {r['ms']:.4f} plain {r['plain_ms']:.4f} library "
                f"{lib} bound {r['bound_ms']:.4f} ({r['bound_by']}) | "
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
        if name in ("flash_bwd", "flash_bwd_tf32x3"):  # _bwd_impl's two TPU kernels: dq :444, dk/dv :474
            state["kernels"][name]["replaces_also"] = "vdtpu/ops/pallas/flash.py:474"
        if name == "attn_fwd_wide":  # Mode NoMax: _nomax_slim_kernel, _nomax_packed_kernel
            state["kernels"][name]["replaces_also"] = "vdtpu/ops/pallas/flash.py:223"
        if name == "gn_silu_q":  # _gn_silu_q_blocked's apply pass
            state["kernels"][name]["replaces_also"] = "vdtpu/ops/pallas/gn_silu.py:210"
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


def _gn_sites(system, c_type: str = "text"):
    """GroupNorm calls of one request: every GN module of the image
    diffuser's data blocks and the ``c_type`` diffuser's context blocks runs
    once per UNet call, every VAE-decoder GN once per decode (and every
    VAE-encoder GN once per encode: the third number)."""
    from vdtpu_torch.models.layers import GroupNorm32
    count = lambda mods: sum(isinstance(m, GroupNorm32) for mod in mods for m in mod.modules())
    unet = (count(system.model.diffuser["image"].data_blocks)
            + count(system.model.diffuser[c_type].context_blocks))
    return unet, count([system.vae["image"].decoder]), count([system.vae["image"].encoder])


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


def phase_gn_sweep(state):
    import torch
    from vdtpu_torch.ops.gn_silu import (GN_CLUSTERS, gn_cluster_capacity, gn_launch_plan,
                                         gn_plan, gn_silu_plain, gn_variant)
    caps = {k: gn_cluster_capacity(k, 512, 131072) for k in GN_CLUSTERS}  # one CTA an SM
    log(f"gn_sweep: clusters of k the card holds at one CTA an SM {caps} "
        f"(gn_silu.GN_CLUSTERS {GN_CLUSTERS}) [{state.get('card')}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for shape in GN_SWEEP_SHAPES:
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        w = (torch.rand(shape[1], device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
        b = (torch.randn(shape[1], device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        ref, out = gn_silu_plain(x, w, b), torch.empty_like(x)
        chosen = gn_plan(shape, torch.bfloat16, 32)
        ms = {}
        for route in ("resident", "streaming"):
            for k in (1, 2, 4, 8, 16):
                plan = gn_variant(shape, torch.bfloat16, 32, route, k)
                if plan is None:
                    continue
                run = lambda: gn_launch_plan(x, w, b, out, 32, 1e-5, True, plan)
                run()
                if not compare(out, ref)[2]:
                    failed.append(f"{shape} {route} k{k}")
                ms[f"{route} k{k} x{plan.clusters}"] = time_graph_ms(run)
        best = min(ms, key=ms.get)
        rows.append(dict(shape=list(shape), chosen=f"{chosen.route} k{chosen.cluster}", ms=ms,
                         fastest=best))
        log(f"gn_sweep {shape}: plan {chosen.route} k{chosen.cluster}, fastest {best} | device "
            f"ms (graph) {json.dumps({k: round(v, 4) for k, v in ms.items()})} "
            f"[{state.get('card')}]")
        torch.cuda.empty_cache()
    state["gn_sweep"] = dict(cluster_capacity=caps, shapes=rows)
    if failed:
        raise RuntimeError(f"gn_sweep: variants disagree with the plain version: {failed}")


def phase_gnq_sweep(state):
    """The int8 GN kernels' plan measured: at each GNQ_SWEEP_SHAPES site
    every geometry ``gnq_variants`` gives (gn_silu_q: Cs 32, 16 and 8,
    threads, pixels a tile; gn_stats: the cooperative kernel's general route
    with Cs 16 and 8, and the group route), each held to its plain version,
    against gnq_plan's choice; and the card's blocks per SM of each
    cooperative geometry against the plan's assumption
    (``gnq_blocks_per_sm``). gn_silu_q's plan is also traced
    (``_gnq_trace``)."""
    import torch
    from vdtpu_torch.ops.gn_silu import (gn_silu_q_plain, gn_stats_plain, gnq_blocks_per_sm,
                                         gnq_card_blocks_per_sm, gnq_launch_plan, gnq_plan,
                                         gnq_variants)
    from vdtpu_torch.ops.qconv import sm_count
    sms, bf = sm_count(0), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed, residency = [], [], {}

    def label(p):
        if p.route == "group":
            return f"group t{p.threads} x{p.ctas}"
        return f"{p.route} cs{p.cs} t{p.threads} p{p.pixels} x{p.ctas}"

    for shape in GNQ_SWEEP_SHAPES:
        c = shape[1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(bf)
        w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(bf)
        b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(bf)
        s = torch.tensor(0.02, device="cuda")
        for stats in (False, True):
            ref = gn_stats_plain(x) if stats else gn_silu_q_plain(x, w, b, s)
            out = torch.empty_like(ref)
            args = () if stats else (w, b, s)
            chosen = gnq_plan(shape, bf, 32, sms, stats)
            plans = {}
            for cs in ((16, 8) if stats else (32, 16, 8)):
                if c % cs == 0:
                    plans.update((label(p), p) for p in gnq_variants(shape, bf, 32, sms, stats,
                                                                     cs=cs))
            ms = {}
            for name, plan in plans.items():
                run = lambda: gnq_launch_plan(x, out, plan, 32, 1e-5, *args)
                run()
                if not _gnq_agree(out, ref, stats)[2]:
                    failed.append(f"{shape} {'stats' if stats else 'q'} {name}")
                key = (stats, plan.cs, plan.route, plan.threads, plan.smem_bytes)
                if plan.route != "group" and key not in residency:
                    residency[key] = (gnq_card_blocks_per_sm(plan, bf, stats),
                                      gnq_blocks_per_sm(plan.threads, plan.smem_bytes))
                ms[name] = time_graph_ms(run)
            best = min(ms, key=ms.get)
            kernel = "gn_stats" if stats else "gn_silu_q"
            rows.append(dict(shape=list(shape), kernel=kernel, chosen=label(chosen),
                             chosen_ms=ms[label(chosen)], fastest=best, ms=ms))
            if not stats:
                rows[-1]["trace_us"] = _gnq_trace(
                    state, shape, chosen, lambda: gnq_launch_plan(x, out, chosen, 32, 1e-5,
                                                                  *args))
            log(f"gnq_sweep {kernel} {shape}: plan {label(chosen)} {ms[label(chosen)]:.4f} ms, "
                f"fastest {best} {ms[best]:.4f} | device ms (graph) "
                f"{json.dumps({k: round(v, 4) for k, v in sorted(ms.items(), key=lambda kv: kv[1])})}"
                f" [{state.get('card')}]")
            torch.cuda.empty_cache()
    short = {k: v for k, v in residency.items() if v[0] < v[1]}
    log(f"gnq_sweep: blocks an SM on the card against the plan's assumption, (stats, cs, "
        f"route, threads, smem) -> (card, plan): {json.dumps({str(k): v for k, v in residency.items()})}")
    state["gnq_sweep"] = dict(shapes=rows, residency={str(k): v for k, v in residency.items()})
    if failed or short:
        raise RuntimeError(f"gnq_sweep: variants disagree with the plain version {failed}; "
                           f"the card holds fewer blocks than planned {short}")


def _gnq_trace(state, shape, plan, run) -> dict:
    """One traced launch of a cooperative gn_silu_q plan (csrc/gn_q.cu's
    vd_gnq_set_trace, %globaltimer at each phase of every CTA): for each
    stamp, its min / median / max over the CTAs in us from the first CTA's
    start; logged and returned."""
    import ctypes
    import torch
    from vdtpu_torch.ops.gn_silu import _gnq_lib
    run()
    buf = torch.zeros(plan.ctas * 8, dtype=torch.int64, device="cuda")
    lib = _gnq_lib()
    torch.cuda.synchronize()
    lib.vd_gnq_set_trace(ctypes.c_void_p(buf.data_ptr()))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        lib.vd_gnq_set_trace(ctypes.c_void_p(0))
    t = buf.view(-1, 8).double()
    rel = (t[:, :6] - t[:, 0].min()) / 1e3
    names = ("start", "phase 1 done", "barrier passed", "statistics", "codes", "end")
    out = {n: [round(float(rel[:, i].quantile(q)), 3) for q in (0.0, 0.5, 1.0)]
           for i, n in enumerate(names)}
    log(f"gnq_sweep trace gn_silu_q {shape} (us from the first CTA's start, min / median / "
        f"max over {plan.ctas} CTAs): {json.dumps(out)} [{state.get('card')}]")
    return out


def phase_wide_sweep(state):
    """The wide heads' block heights and key tiles measured (see the
    docstring's phase list)."""
    import ctypes
    import torch
    from vdtpu_torch.ops.flash import _plan_for, flash_attention, flash_attention_plain
    from vdtpu_torch.ops.kernels import build
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "wide_sweep")
    os.makedirs(out, exist_ok=True)
    cases = "\n".join(f"    case {i}: return vdattn::launch_wg<{dp}, {nc}, vdattn::Mode::Flash, "
                      f"{bk}>(a, st);" for i, (dp, nc, bk) in enumerate(WIDE_SWEEP_VARIANTS))
    src, lib_path = os.path.join(out, "wide_sweep.cu"), os.path.join(out, "libwide_sweep.so")
    with open(src, "w") as f:
        f.write(WIDE_SWEEP_SRC.replace("CASES", cases))
    t = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xcompiler",
                           "-fvisibility=hidden", "-I", build.CSRC_DIR, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"wide_sweep: nvcc failed: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    regs = re.findall(r"Compiling entry function '\w+?Li(\d+)ELi(\d+)E\w+?ModeE0ELi(\d+)\w*'"
                      r".*?Used (\d+) registers", proc.stdout + proc.stderr, re.S)
    log(f"wide_sweep: built in {time.perf_counter() - t:.1f} s; registers (d, warpgroups, key "
        f"tile, registers) {regs}")
    fn = ctypes.CDLL(lib_path).vd_wide_sweep
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    st = lambda x: tuple(x.stride()[:3])
    rows = []
    for b, n, h, d, m in WIDE_SWEEP_SHAPES:
        q, k, v = (torch.randn(b, r, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for r in (n, m, m))
        ref, plan = flash_attention_plain(q, k, v), _plan_for(q, k, v)
        calls = {"plan": lambda: flash_attention(q, k, v)}
        errs = {}
        for i, (dp, nc, bk) in enumerate(WIDE_SWEEP_VARIANTS):
            if dp != plan.dp:
                continue
            o = torch.empty_like(q)

            def call(i=i, o=o):
                rc = fn(i, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, m, h, d,
                        *st(q), *st(k), *st(v), *st(o), d ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"wide_sweep variant {WIDE_SWEEP_VARIANTS[i]}: "
                                       f"cudaError {rc}")
            call()
            torch.cuda.synchronize()
            err, rel, ok = compare(o, ref)
            if not (ok and rel <= ATTN_MAX_REL_L2):
                raise RuntimeError(f"wide_sweep variant {(dp, nc, bk)} at {(b, n, h, d, m)}: "
                                   f"max_abs_err {err}, rel_l2 {rel}")
            calls[f"{nc} warpgroups, {bk}-key tiles"] = call
            errs[f"{nc} warpgroups, {bk}-key tiles"] = rel
        times = {name: [] for name in calls}
        for _ in range(2):   # in turns
            for name, call in calls.items():
                times[name].append(time_graph_ms(call))
        row = dict(shape=[b, n, h, d, m], plan=dict(block_q=plan.block_q, block_k=plan.block_k,
                                                    stages=plan.stages), ms=times, rel_l2=errs)
        rows.append(row)
        log(f"wide_sweep {(b, n, h, d, m)}: the plan ({plan.block_q} query rows, "
            f"{plan.block_k}-key tiles, {plan.stages} stages) and the variants, device ms in "
            f"turns: {json.dumps({k: [round(x, 5) for x in t] for k, t in times.items()})}; "
            f"relative L2 {json.dumps({k: round(x, 6) for k, x in errs.items()})} "
            f"[{state.get('card')}]")
    state["wide_sweep"] = rows


def phase_gnq_compare(state):
    import statistics
    import torch
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain
    from vdtpu_torch.ops.quant import QuantPolicy
    from vdtpu_torch.serving.api import VDInference
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for shape in GNQ_SHAPES:
        c = shape[1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
        b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
        s = torch.tensor(0.02, device="cuda")
        row = dict(shape=list(shape))
        for name, kern, plain, stats in (
                ("gn_silu_q", lambda: gn_silu_q(x, w, b, s), lambda: gn_silu_q_plain(x, w, b, s),
                 False),
                ("gn_stats", lambda: gn_stats(x), lambda: gn_stats_plain(x), True)):
            ok = _gnq_agree(kern(), plain(), stats)[2]
            torch.cuda.synchronize()
            if not ok:
                failed.append(f"{name}{shape}")
            row[name] = dict(ok=ok, ms=time_graph_ms(kern), eager_ms=time_ms(kern, 50))
        rows.append(row)
        log(f"gnq_compare {shape}: {json.dumps(row)} [{state.get('card')}]")
        torch.cuda.empty_cache()
    system = _system(state)
    _calibrate(state, system, "gnq_compare")
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    prompt = "a red cat sitting on a wooden bench in the sun"
    policies = (("default", system.quant_policy),
                ("gn_prologue=fused", QuantPolicy(gn_prologue="fused")))
    secs = {mode: [] for mode, _ in policies}
    for rnd in range(GNQ_COMPARE_ROUNDS + 1):   # round 0 warms each policy up
        for mode, pol in policies:
            with _policy(system, pol):
                torch.cuda.synchronize()
                t = time.perf_counter()
                img = vdi.inference_t2i(prompt, seed=SEED)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
            if not bool(torch.isfinite(img).all()):
                failed.append(f"request {mode} round {rnd}: non-finite output")
            if rnd:
                secs[mode].append(dt)
    med = {mode: statistics.median(v) for mode, v in secs.items()}
    diff = statistics.median(f - d for f, d in zip(secs["gn_prologue=fused"], secs["default"]))
    log(f"gnq_compare requests (t2i 512^2, n = 2, DDIM-{STEPS}, warm, in turn): median s "
        f"{json.dumps(med)}, median of fused - default a round {diff:.4f} s; every request s "
        f"{json.dumps(secs)} [{state.get('card')}]")
    state["gnq_compare"] = dict(kernels=rows, requests=secs, median_s=med,
                                fused_minus_default_s=diff)
    if failed:
        raise RuntimeError(f"gnq_compare: {failed}")


def phase_main(state):
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    unet_gn, vae_gn, _ = _gn_sites(system)
    expect = {"flash_fwd": 10 * STEPS, "gn_silu": unet_gn * STEPS + vae_gn}
    prompt = "a red cat sitting on a wooden bench in the sun"
    results = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t = time.perf_counter()
        img = vdi.inference_t2i(prompt, seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
        paths = _wgmma_only(f"main {run}")
        gn_routes = _gn_routes(f"main {run}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(img).all())
        lo, hi = float(img.min()), float(img.max())
        shape_ok = tuple(img.shape) == (2, 512, 512, 3)
        log(f"main {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak {peak:.2f} GiB, "
            f"shape {tuple(img.shape)} finite {finite} range [{lo:.4f}, {hi:.4f}], "
            f"launches {counts} (expected {expect}), attention by path {paths}, GN by route "
            f"{gn_routes} [{state.get('card')}]")
        if not (finite and shape_ok and lo >= 0.0 and hi <= 1.0):
            raise RuntimeError(f"main {run}: bad output")
        if counts != expect:
            raise RuntimeError(f"main {run}: launch counts {counts} != {expect}")
        results[run] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak, launches=counts,
                            attention_by_path=paths, gn_by_route=gn_routes)
    for name, n in results["warm"]["launches"].items():
        if name in state["kernels"]:
            state["kernels"][name]["launches"] = n
            state["kernels"][name]["path"] = "main (bf16 exact, warm request)"
    if "flash_fwd" in state["kernels"]:
        state["kernels"]["flash_fwd"]["launches_by_path"] = \
            results["warm"]["attention_by_path"]["flash_fwd"]
    if "gn_silu" in state["kernels"]:
        state["kernels"]["gn_silu"]["launches_by_path"] = results["warm"]["gn_by_route"]
    state["main"] = results


def phase_main_f32(state):
    """The port's default dtype end to end: one 2-image t2i request (512^2,
    DDIM-50, CFG 7.5) on ``VDSystem("vd_four_flow_v1-0")`` in f32 holding
    ``main``'s seeded weights, once, in a process ``main`` has warmed (the
    default run nears its time limit: cold and warm read 2.927 / 2.705 s on
    an H100): 500 flash launches, every one on the tf32x3 kernel (none on
    "f32", "mma" or "wgmma"), the GN kernel at every site; seconds, peak GiB
    (the bf16 system of ``main`` included); outputs finite, in [0, 1], of
    their shape. Then one f32 eps call against f32 on the CPU on the same
    weights and inputs (``_eps_ref``, shared with ``eps``), with the card's
    default TF32 flags (printed: cuDNN's convolutions run TF32) and with
    TF32 off (F32_EPS_*). Then main_mcg's four-image mcg request (c) in f32,
    once: its flash launches as ``_mc_launches`` derives them (1250), every
    one on the tf32x3 kernels, its 250 d-160 cross-attentions on the wide
    one (csrc/tf32x3_fwd_wide.cu); output finite, in [0, 1], of its shape;
    every distinct flash site of the request held to its plain version in
    f32 (``_flash_site_check``)."""
    import gc
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference, VDSystem
    t0 = time.perf_counter()
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.float32, device="cuda")
    with torch.no_grad():  # main's seeded weights, upcast
        src = _system(state).net.state_dict()
        for name, tensor in system.net.state_dict().items():
            tensor.copy_(src[name])
    torch.cuda.synchronize()
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"main_f32: f32 system built from main's weights in {time.perf_counter() - t0:.1f} s; "
        f"TF32 flags as a request finds them: {flags}")
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    unet_gn, vae_gn, _ = _gn_sites(system)
    expect = {"flash_fwd": 10 * STEPS, "gn_silu": unet_gn * STEPS + vae_gn}
    expect_paths = {"wgmma": 0, "mma": 0, "f32": 0, "tf32x3": 10 * STEPS}
    prompt = "a red cat sitting on a wooden bench in the sun"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t = time.perf_counter()
    img = vdi.inference_t2i(prompt, seed=SEED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
    paths = dict(flash_attention.launches_by_path)
    gn_routes = _gn_routes("main_f32")
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(img).all())
    lo, hi = float(img.min()), float(img.max())
    log(f"main_f32 request: {dt:.3f} s, {2 / dt:.3f} images/s, peak {peak:.2f} GiB, shape "
        f"{tuple(img.shape)} finite {finite} range [{lo:.4f}, {hi:.4f}], launches {counts} "
        f"(expected {expect}), flash by path {paths} (expected {expect_paths}), GN by route "
        f"{gn_routes} [{state.get('card')}]")
    if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0 and hi <= 1.0):
        raise RuntimeError("main_f32: bad output")
    if counts != expect or paths != expect_paths:
        raise RuntimeError(f"main_f32: launches {counts} by path {paths} != {expect} / "
                           f"{expect_paths}")
    results = {"request": dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak, launches=counts,
                               flash_by_path=paths, gn_by_route=gn_routes)}
    del img, vdi

    # one eps call (the t2i UNet: image data blocks, text context blocks) on
    # the inputs and weights of the shared CPU reference
    ref = _eps_ref(state)
    x, t, ctx = ref["x"].float(), ref["t"], ref["ctx"].float()
    _zero_counters()
    with torch.no_grad():
        eps_default = system.model.apply_model(x, t, ctx, "image", "text").cpu()
        with _no_tf32():
            eps_exact = system.model.apply_model(x, t, ctx, "image", "text").cpu()
    eps_paths = dict(flash_attention.launches_by_path)
    eps_cpu, cpu_s = ref["eps_cpu"], ref["cpu_s"]
    cos, rel = _agreement(eps_default, eps_cpu)
    cos0, rel0 = _agreement(eps_exact, eps_cpu)
    log(f"main_f32 eps [1, 4, 64, 64] f32 card vs f32 cpu: default flags {flags}: cosine "
        f"{cos:.8f} rel_l2 {rel:.3e} (limits cos >= {F32_EPS_MIN_COS}, rel_l2 <= "
        f"{F32_EPS_MAX_REL_L2}: cuDNN's TF32 convs); TF32 off: cosine {cos0:.10f} rel_l2 "
        f"{rel0:.3e} (limit rel_l2 <= {F32_EPS_NO_TF32_MAX_REL_L2}); flash by path {eps_paths}; "
        f"cpu {cpu_s:.1f} s [{state.get('card')}]")
    results["eps"] = dict(flags=flags, cosine=cos, rel_l2=rel, cosine_no_tf32=cos0,
                          rel_l2_no_tf32=rel0, flash_by_path=eps_paths)
    state["main_f32"] = results
    if "flash_fwd_tf32x3" in state["kernels"]:
        k = state["kernels"]["flash_fwd_tf32x3"]
        k["launches"] = results["request"]["flash_by_path"]["tf32x3"]
        k["path"] = "main_f32 (f32 exact t2i request)"
    if not (math.isfinite(cos) and cos >= F32_EPS_MIN_COS and rel <= F32_EPS_MAX_REL_L2
            and rel0 <= F32_EPS_NO_TF32_MAX_REL_L2 and eps_paths["tf32x3"] == 20):
        raise RuntimeError("main_f32: the f32 eps call disagrees with f32 on the CPU")
    results["mcg"] = _f32_mcg(state, system)
    del system
    gc.collect()
    torch.cuda.empty_cache()


def _f32_mcg(state, system):
    """main_mcg's four-image mcg request (c) on the f32 system, once (see
    ``phase_main_f32``)."""
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    images, mask = _mcg_inputs()
    _, call, n_shown, contexts = next(r for r in _mcg_requests(vdi, images, mask)
                                      if r[0] == "c")
    expect, bf16_paths, wide = _mc_launches(system, contexts)
    expect_paths = {"wgmma": 0, "mma": 0, "f32": 0, "tf32x3": sum(bf16_paths.values())}
    expect_wide = {"wgmma": 0, "tf32x3": wide}
    calls = []
    torch.cuda.synchronize()
    _zero_counters()
    t = time.perf_counter()
    with _recording_flash(calls, distinct=True):
        shown, img = call()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
    paths = dict(flash_attention.launches_by_path)
    got_wide = dict(flash_attention.launches_wide)
    finite = bool(torch.isfinite(img).all())
    lo, hi = float(img.min()), float(img.max())
    log(f"main_f32 mcg (c): {dt:.3f} s (once, cold), shape {tuple(img.shape)} finite {finite} "
        f"range [{lo:.4f}, {hi:.4f}], inputs shown {len(shown)} (expected {n_shown}), "
        f"launches {counts} (expected {expect}), flash by path {paths} (expected "
        f"{expect_paths}), at heads over 80 {got_wide} (expected {expect_wide}) "
        f"[{state.get('card')}]")
    if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0 and hi <= 1.0
            and len(shown) == n_shown):
        raise RuntimeError("main_f32 mcg: bad output")
    if counts != expect or paths != expect_paths or got_wide != expect_wide:
        raise RuntimeError(f"main_f32 mcg: launches {counts} by path {paths} wide {got_wide} "
                           f"!= {expect} / {expect_paths} / {expect_wide}")
    del img, shown
    rows = _flash_site_check(state, "main_f32 mcg (c)", calls)
    if "flash_fwd_tf32x3_wide" in state["kernels"]:
        k = state["kernels"]["flash_fwd_tf32x3_wide"]
        k["launches"] = got_wide["tf32x3"]
        k["path"] = "main_f32 (four-image mcg, f32 exact)"
        k["site_checks"] = [r for r in rows if r["site"][0][-1] > 80]
    return dict(seconds=dt, launches=counts, flash_by_path=paths, flash_wide=got_wide,
                sites=rows)


def _i2i_image(seed: int, h: int = 512, w: int = 512):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((1, h, w, 3), device="cuda", generator=gen)


def _i2i_launches(system, steps: int, with_encoder: bool):
    """Launches of one exact i2i request, derived from the program: the 10
    long self-attention sites of the image diffuser's context blocks take
    the flash kernel per UNet call (the CLIP vision tower's 257 tokens and
    the VAE's 512-wide heads take the plain path), every GroupNorm of the
    image data blocks and context blocks, of the VAE decoder and (fid > 0)
    of the VAE encoder the GN kernel."""
    unet_gn, dec_gn, enc_gn = _gn_sites(system, "image")
    return {"flash_fwd": 10 * steps,
            "gn_silu": unet_gn * steps + dec_gn + (enc_gn if with_encoder else 0)}


I2I_REQUESTS = (("a", 0.0, 0.5, None, STEPS), ("b", 0.5, 0.3, "Simple", I2I_FID_STEPS))


def phase_main_i2i(state):
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference, regularize_image
    system = _system(state)
    vdi = VDInference(system, output_dim=(512, 512), ddim_steps=STEPS, n_sample_image=2)
    image = _i2i_image(SEED + 5)
    odd = _i2i_image(SEED + 6, 600, 451)
    reg = regularize_image(odd, (512, 512))
    torch.cuda.synchronize()
    log(f"main_i2i: regularize_image [1, 600, 451, 3] -> {tuple(reg.shape)}, range "
        f"[{float(reg.min()):.4f}, {float(reg.max()):.4f}]")
    if tuple(reg.shape) != (1, 512, 512, 3) or not (0.0 <= float(reg.min())
                                                    and float(reg.max()) <= 1.0):
        raise RuntimeError("main_i2i: regularize_image gave a bad result")
    results = {}
    for label, fid, fcs, clr, steps in I2I_REQUESTS:
        expect = _i2i_launches(system, steps, fid != 0)
        for run in ONCE:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counters()
            t = time.perf_counter()
            img = vdi.inference_i2i(image, fid, fcs, clr, seed=SEED)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
            paths = _wgmma_only(f"main_i2i ({label}) {run}")
            gn_routes = _gn_routes(f"main_i2i ({label}) {run}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            finite = bool(torch.isfinite(img).all())
            lo, hi = float(img.min()), float(img.max())
            log(f"main_i2i ({label}) fid {fid} fcs {fcs} clr {clr} {run}: {dt:.3f} s, "
                f"{2 / dt:.3f} images/s, peak {peak:.2f} GiB, shape {tuple(img.shape)} finite "
                f"{finite} range [{lo:.4f}, {hi:.4f}], launches {counts} (expected {expect}), "
                f"attention by path {paths}, GN by route {gn_routes} [{state.get('card')}]")
            if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0 and hi <= 1.0):
                raise RuntimeError(f"main_i2i ({label}) {run}: bad output")
            if counts != expect:
                raise RuntimeError(f"main_i2i ({label}) {run}: launch counts {counts} != {expect}")
            results[f"{label}_{run}"] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak,
                                             launches=counts)
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            state["kernels"][name]["launches_i2i_a"] = results["a_once"]["launches"][name]
    state["main_i2i"] = results


def _text_launches(system, c_type: str):
    """Launches of one exact text-flow request, derived from the program:
    every GroupNorm of the text diffuser's data blocks and of the
    ``c_type`` diffuser's context blocks runs the GN kernel once per UNet
    call (x STEPS); nothing takes the flash kernel (the 0-D context blocks
    attend over 4 tokens, CLIP's vision tower over 257, BERT and GPT-2 over
    at most 77 and 31), and the text VAE has LayerNorms only."""
    from vdtpu_torch.models.layers import GroupNorm32
    d = system.model.diffuser
    n = sum(isinstance(m, GroupNorm32)
            for mod in (d["text"].data_blocks, d[c_type].context_blocks) for m in mod.modules())
    return {"flash_fwd": 0, "gn_silu": n * STEPS}


@contextlib.contextmanager
def _recording_decode(vae, calls: list):
    """Record (latent, token ids, seconds) of every ``decode_ids`` call of
    the text VAE; the seconds run between two synchronizes."""
    import torch
    inner = vae.decode_ids

    def record(z, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids = inner(z, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append((z.detach().clone(), ids.clone(), time.perf_counter() - t))
        return ids

    vae.decode_ids = record
    try:
        yield
    finally:
        del vae.decode_ids


def _check_rows(ids, vae, vocab: int) -> bool:
    """BOS first, an EOS by the last step and EOS after it, ids in the vocabulary."""
    import torch
    eos = ids == vae.eos_id
    after = torch.cumsum(eos.int(), dim=1) > 0
    return (bool((ids[:, 0] == vae.bos_id).all()) and bool(eos.any(dim=1).all())
            and bool((eos | ~after).all()) and bool(((ids >= 0) & (ids < vocab)).all()))


def _cpu_f32(module, build_fn):
    """An f32 CPU copy of ``module``: ``build_fn()`` builds its twin on the
    meta device, which then takes the weights."""
    import torch
    with torch.device("meta"):
        cpu = build_fn()
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: v.float().cpu() for k, v in module.state_dict().items()})
    return cpu.eval()


def _cpu_model(system):
    """A VDModel whose diffusers are an f32 CPU copy of the system's."""
    import torch
    from vdtpu_torch.models.vd import VDModel
    with torch.device("meta"):
        model = VDModel.from_config(system.cfg)
    model.diffuser = _cpu_f32(system.model.diffuser, lambda: model.diffuser)
    return model


@contextlib.contextmanager
def _recording_gn(calls: list):
    """Record the arguments of every GroupNorm32 call to the GN(+SiLU)
    wrapper (the input cloned, all detached from any graph), calling
    through."""
    from vdtpu_torch.models import layers
    inner = layers.gn_silu

    def record(x, weight, bias, groups, eps, silu):
        calls.append((x.detach().clone(), weight.detach(), bias.detach(), groups, eps))
        return inner(x, weight, bias, groups, eps, silu)

    layers.gn_silu = record
    try:
        yield
    finally:
        layers.gn_silu = inner


def _gn_site_check(state, label: str, calls):
    """The GN(+SiLU) kernel against its plain version, with and without
    SiLU, at each distinct recorded site (input shape, dtype, groups, eps)
    on that site's own input and affine parameters, within the two-ulp
    band (16-bit inputs) or GN_F32_ATOL / GN_F32_RTOL (f32 inputs)."""
    import torch
    from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_plain
    seen, rows = set(), []
    for x, w, b, groups, eps in calls:
        sig = (tuple(x.shape), str(x.dtype).removeprefix("torch."), groups, eps)
        if sig in seen:
            continue
        seen.add(sig)
        band = (GN_F32_ATOL, GN_F32_RTOL) if x.dtype == torch.float32 else (ATOL, RTOL)
        for silu in (True, False):
            err, rel, ok = compare(gn_silu(x, w, b, groups, eps, silu),
                                   gn_silu_plain(x, w, b, groups, eps, silu), *band)
            rows.append(dict(site=[list(sig[0]), sig[1], groups, eps, silu],
                             max_abs_err=err, rel_l2_err=rel, ok=ok, band=list(band)))
    torch.cuda.synchronize()
    bad = [r["site"] for r in rows if not r["ok"]]
    log(f"  site check gn_silu ({label}): {len(seen)} distinct sites of {len(calls)} calls, "
        f"{sorted(seen)}, with and without SiLU: "
        f"max_abs_err {max(r['max_abs_err'] for r in rows):.3e}, max rel_l2 "
        f"{max(r['rel_l2_err'] for r in rows):.3e}, disagreeing {bad} [{state.get('card')}]")
    if bad:
        raise RuntimeError(f"gn_silu disagrees with its plain version at {label} sites {bad}")
    if "gn_silu" in state["kernels"]:
        k = state["kernels"]["gn_silu"]
        k.setdefault("site_checks", {})[label] = rows
        k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in rows))
    return rows


def phase_main_text(state):
    import torch
    from vdtpu_torch.config.registry import build
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    vae = system.vae["text"]
    vocab = vae.decoder.transformer.wte.num_embeddings
    dim = dict(system.cfg["args"]["diffuser_cfg_list"])["text"]["args"]["input_channels"]
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_text=4, text_latent_dim=dim)
    image = _i2i_image(SEED + 5)
    requests = (("i2t", "image", lambda: vdi.inference_i2t(image, seed=SEED)),
                ("t2t", "text", lambda: vdi.inference_t2t(TEXT_PROMPT, seed=SEED)))
    results = {}
    for label, c_type, run_request in requests:
        expect = _text_launches(system, c_type)
        for run in ONCE:
            calls = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counters()
            with _recording_decode(vae, calls):
                t = time.perf_counter()
                texts = run_request()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
            counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
            gn_routes = _gn_routes(f"main_text {label} {run}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            (z, ids, decode_s), = calls
            z_ok = tuple(z.shape) == (4, dim) and bool(torch.isfinite(z).all())
            rows_ok = tuple(ids.shape) == (4, 30) and _check_rows(ids, vae, vocab)
            log(f"main_text {label} {run}: {dt:.3f} s (GPT-2 decode {decode_s:.3f} s), peak "
                f"{peak:.2f} GiB, latent "
                f"{tuple(z.shape)} finite {z_ok}, ids {tuple(ids.shape)} well-formed {rows_ok}, "
                f"launches {counts} (expected {expect}), GN by route {gn_routes}, texts {texts} "
                f"[{state.get('card')}]")
            if not (z_ok and rows_ok and len(texts) == 4):
                raise RuntimeError(f"main_text {label} {run}: bad output")
            if counts != expect:
                raise RuntimeError(f"main_text {label} {run}: launch counts {counts} != {expect}")
            results[f"{label}_{run}"] = dict(seconds=dt, decode_s=decode_s, peak_gib=peak,
                                             launches=counts, texts=texts)
        state.setdefault("text_latents", {})[label] = z

    # one full-width text-diffuser eps call per context type at the
    # requests' UNet batch (n_sample_text x CFG), its GN kernel calls
    # recorded for the site check, and the first decode step's logits,
    # bf16 on the card against f32 on the CPU
    t0 = time.perf_counter()
    n = 2 * 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(n, dim, device="cuda", generator=gen).to(system.dtype)
    tt = torch.full((n,), 500, device="cuda")
    ctxs = {"text": system.ctx_encode(stand_in_tokenizer([TEXT_PROMPT] * n), "text"),
            "image": system.ctx_encode(image, "image").repeat(n, 1, 1)}
    cpu_model = _cpu_model(system)
    eps_gates, gn_calls = {}, []
    with torch.no_grad():
        for c_type, ctx in ctxs.items():
            with _recording_gn(gn_calls):
                eps_gpu = system.model.apply_model(x, tt, ctx, "text", c_type).float().cpu()
            eps_cpu = cpu_model.apply_model(x.float().cpu(), tt.cpu(), ctx.float().cpu(),
                                            "text", c_type)
            eps_gates[c_type] = _cosine(eps_gpu, eps_cpu)
    del cpu_model
    gn_rows = _gn_site_check(state, "main_text", gn_calls)
    dec_cfg = dict(system.cfg["args"]["vae_cfg_list"])["text"]["args"]["decoder"]
    cpu_dec = _cpu_f32(vae.decoder, lambda: build(dec_cfg))
    z = state["text_latents"]["t2t"]
    bos = torch.full((4, 1), vae.bos_id, dtype=torch.long, device="cuda")
    with torch.no_grad():
        logits_gpu = vae.decoder(bos, z)[:, 0].float().cpu()
        logits_cpu = cpu_dec(bos.cpu(), z.float().cpu())[:, 0]
        logit_cos, logit_rel = _cosine(logits_gpu, logits_cpu)
        # the bf16 and f32 decodes on one Gumbel table: argmax flips between
        # the dtypes are expected, so agreeing rows are counted, not gated
        g = torch.Generator(device="cuda").manual_seed(SEED + 8)
        table = -torch.log(-torch.log(torch.rand((29, 4, vocab), device="cuda", generator=g)
                                      .clamp_min(torch.finfo(torch.float32).tiny)))
        ids_gpu = vae.decode_ids(z, gumbel_table=table).cpu()
        ids_cpu = cpu_dec.generate(z.float().cpu(), gumbel_table=table.cpu(),
                                   eos_token=vae.eos_id, bos_token=vae.bos_id)
    rows_agree = int((ids_gpu == ids_cpu).all(dim=1).sum())
    dt = time.perf_counter() - t0
    eps_txt = ", ".join(f"c_type {c}: cosine {cos:.6f} rel_l2 {rel:.5f}"
                        for c, (cos, rel) in eps_gates.items())
    log(f"main_text: text-diffuser eps [{n}, {dim}] card bf16 vs cpu f32: {eps_txt} (limits cos >= "
        f"{EPS_MIN_COS}, rel_l2 <= {EPS_MAX_REL_L2}); first decode step logits [4, {vocab}]: "
        f"cosine {logit_cos:.6f} rel_l2 {logit_rel:.5f} (limit cos >= {LOGITS_MIN_COS}); "
        f"decoded rows equal bf16 vs f32 on shared Gumbel draws: {rows_agree} of 4 (not "
        f"gated); cpu {dt:.1f} s [{state.get('card')}]")
    results.update(eps=eps_gates, logits=dict(cosine=logit_cos, rel_l2=logit_rel),
                   rows_agree_bf16_f32=rows_agree, gn_sites=gn_rows)
    state["main_text"] = results
    bad = [c for c, (cos, rel) in eps_gates.items()
           if not (math.isfinite(cos) and cos >= EPS_MIN_COS and rel <= EPS_MAX_REL_L2)]
    if bad or not (math.isfinite(logit_cos) and logit_cos >= LOGITS_MIN_COS):
        raise RuntimeError(f"main_text: card disagrees with f32 on the CPU (eps {eps_gates}, "
                           f"logits cosine {logit_cos})")
    if "gn_silu" in state["kernels"]:
        for label in ("i2t", "t2t"):
            state["kernels"]["gn_silu"][f"launches_{label}"] = \
                results[f"{label}_once"]["launches"]["gn_silu"]


def _mcg_inputs():
    """The seeded inputs of main_mcg's requests: four 512^2 images and a
    rectangular mask [1, 512, 512, 1] (1 hides a pixel)."""
    import torch
    images = [_i2i_image(SEED + 20 + i) for i in range(4)]
    mask = torch.zeros((1, 512, 512, 1), device="cuda")
    mask[:, 96:352, 160:448] = 1.0
    return images, mask


def _mcg_requests(vdi, images, mask):
    """(label, call, images used, contexts as (c_type, keys)) of main_mcg's
    requests: (a) dcg, one image and a prompt; (b) tcg given three images
    (the flow keeps two; the second masked) and a prompt; (c) mcg, four
    images and no prompt, whose 4 x 257 = 1028 image tokens reach the
    flash rule's 1024 keys."""
    text = ("text", 77)
    return (
        ("a", lambda: (None, vdi.inference_dcg(images[0], 0.5, TEXT_PROMPT, 0.5, seed=SEED)),
         None, [text, ("image", 257)]),
        ("b", lambda: vdi.inference_tcg(
            [{"image": images[0], "fcs_lvl": 0.5}, {"image": images[1], "mask": mask},
             {"image": images[2]}], TEXT_PROMPT, 0.3, seed=SEED), 2, [text, ("image", 514)]),
        ("c", lambda: vdi.inference_mcg([{"image": im} for im in images], None, 0.5,
                                        seed=SEED), 4, [("image", 1028)]))


def _mc_gn(system, c_types) -> int:
    """GroupNorms of one multi-context UNet call: the image data blocks' and
    those of each context's stack."""
    from vdtpu_torch.models.layers import GroupNorm32
    d = system.model.diffuser
    count = lambda mods: sum(isinstance(m, GroupNorm32) for m in mods.modules())
    return count(d["image"].data_blocks) + sum(count(d[c].context_blocks) for c in c_types)


def _mc_launches(system, contexts):
    """Launches of one exact multi-context request, derived from the
    program: at each context slot every context's stack runs; its
    self-attention takes the flash kernel on maps of 1024 tokens or more,
    its cross-attention on maps of 256 or more when the context has 1024
    keys or more (the flash rule), on the wgmma kernel for heads up to
    ATTN_WG_MAX_D (the forward's limit) and the mma.sync one above; every
    GroupNorm of the UNet call and of the VAE decoder the GN kernel.
    Returns (launches, flash launches by path, flash launches at heads
    over ATTN_WG_NARROW_D: the wide heads' kernels)."""
    from vdtpu_torch.ops.flash import ATTN_WG_MAX_D, ATTN_WG_NARROW_D
    d = system.model.diffuser
    paths, wide = {"wgmma": 0, "mma": 0}, 0
    for ci, n in enumerate(_ctx_tokens(d["image"], 64)):
        for c_type, keys in contexts:
            dh = d[c_type].program.ctx[ci].dim_head
            path = "wgmma" if dh <= ATTN_WG_MAX_D and dh % 8 == 0 else "mma"
            calls = STEPS * ((n >= 1024) + (n >= 256 and keys >= 1024))
            paths[path] += calls
            wide += calls if dh > ATTN_WG_NARROW_D else 0
    _, vae_gn, _ = _gn_sites(system)
    gn = _mc_gn(system, [c for c, _ in contexts]) * STEPS + vae_gn
    return {"flash_fwd": sum(paths.values()), "gn_silu": gn}, paths, wide


def _mc_request(state, label, call, n_shown, expect, expect_paths, expect_kv=None,
                expect_wide=None):
    """Run one multi-context request once (``ONCE``); gate its output, its
    inputs shown and its launches: ``expect``'s counts, every other counter
    of ``_counters`` at 0, the attention forwards by path and (where given)
    the no-max kernel's by kv length and the flash forward's launches at
    heads over 80 (``launches_wide``)."""
    import torch
    by_kv_now = _counters()["nomax_fwd"].launches_by_kv
    results = {}
    for run in ONCE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t = time.perf_counter()
        shown, img = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got, by_kv = _read_counters(), dict(by_kv_now)
        wide = dict(_counters()["flash_fwd"].launches_wide)
        counts = {k: got[k] for k in expect}
        paths = _attn_paths(f"{label} {run}")
        gn_routes = _gn_routes(f"{label} {run}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(img).all())
        lo, hi = float(img.min()), float(img.max())
        n_got = None if shown is None else len(shown)
        log(f"{label} {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak {peak:.2f} GiB, shape "
            f"{tuple(img.shape)} finite {finite} range [{lo:.4f}, {hi:.4f}], inputs shown "
            f"{n_got} (expected {n_shown}), launches {counts} (expected {expect}), attention "
            f"by path {paths} (expected {expect_paths}), flash at heads over 80 {wide} "
            f"(expected {expect_wide}), GN by route {gn_routes}, no-max by kv length {by_kv} "
            f"(expected {expect_kv}) [{state.get('card')}]")
        if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0 and hi <= 1.0):
            raise RuntimeError(f"{label} {run}: bad output")
        if n_got != n_shown or (shown and any(tuple(s.shape) != (1, 512, 512, 3)
                                              for s in shown)):
            raise RuntimeError(f"{label} {run}: inputs shown {n_got} != {n_shown}")
        if got != {k: expect.get(k, 0) for k in got}:
            raise RuntimeError(f"{label} {run}: launch counts {got} != {expect}")
        for name, want in expect_paths.items():
            if paths[name] != want:
                raise RuntimeError(f"{label} {run}: {name} by path {paths[name]} != {want}")
        if expect_kv is not None and by_kv != expect_kv:
            raise RuntimeError(f"{label} {run}: no-max by kv length {by_kv} != {expect_kv}")
        if expect_wide is not None and wide != expect_wide:
            raise RuntimeError(f"{label} {run}: flash at heads over 80 {wide} != {expect_wide}")
        results[run] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak, launches=counts,
                            attention_by_path=paths, gn_by_route=gn_routes, flash_wide=wide)
    return results


def _mc_eps(state, system, cpu_model, label: str, mixing: str, choices=None):
    """One full-width multi-context eps call (text + image context) on the
    card in bf16 against the f32 CPU copy on the same inputs."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen).to(torch.bfloat16)
    t = torch.tensor([500], device="cuda")
    ctxs = [system.ctx_encode(stand_in_tokenizer([TEXT_PROMPT]), "text"),
            system.ctx_encode(_i2i_image(SEED + 5), "image")]
    args = ([0.3, 0.7], "image", ["text", "image"], mixing, choices)
    with torch.no_grad():
        eps_gpu = system.model.apply_model_multicontext(x, t, ctxs, *args).float().cpu()
        t0 = time.perf_counter()
        eps_cpu = cpu_model.apply_model_multicontext(
            x.float().cpu(), t.cpu(), [c.float().cpu() for c in ctxs], *args)
    cos, rel = _cosine(eps_gpu, eps_cpu)
    log(f"{label}: multi-context eps ({mixing} mixing"
        f"{'' if choices is None else f', choices {choices}'}), card bf16 vs cpu f32 at "
        f"[1, 4, 64, 64]: cosine {cos:.6f} rel_l2 {rel:.5f} (limits cos >= {EPS_MIN_COS}, "
        f"rel_l2 <= {EPS_MAX_REL_L2}); cpu {time.perf_counter() - t0:.1f} s "
        f"[{state.get('card')}]")
    if not (math.isfinite(cos) and cos >= EPS_MIN_COS and rel <= EPS_MAX_REL_L2):
        raise RuntimeError(f"{label}: card result disagrees with the f32 CPU result")
    return dict(cosine=cos, rel_l2=rel)


def phase_main_mcg(state):
    import torch
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    images, mask = _mcg_inputs()
    results = {}
    for label, call, n_shown, contexts in _mcg_requests(vdi, images, mask):
        expect, flash_paths, wide = _mc_launches(system, contexts)
        res = _mc_request(state, f"main_mcg ({label})", call, n_shown, expect,
                          {"flash_fwd": flash_paths, "nomax_fwd": {"wgmma": 0, "mma": 0}},
                          expect_wide={"wgmma": wide, "tf32x3": 0})
        for run, r in res.items():
            results[f"{label}_{run}"] = r
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    choices = system.model.sample_layer_choices(gen, [0.3, 0.7], "image").tolist()
    cpu_model = _cpu_model(system)
    results["eps_attention"] = _mc_eps(state, system, cpu_model, "main_mcg", "attention")
    results["eps_layer"] = _mc_eps(state, system, cpu_model, "main_mcg", "layer", choices)
    del cpu_model
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            k = state["kernels"][name]
            for label in "abc":
                k[f"launches_mcg_{label}"] = results[f"{label}_once"]["launches"][name]
            if name == "flash_fwd":
                k["launches_by_path_mcg_c"] = results["c_once"]["attention_by_path"][name]
    if "attn_fwd_wide" in state["kernels"]:   # the 16^2 cross-attentions at d 160
        k = state["kernels"]["attn_fwd_wide"]
        k["launches"] = results["c_once"]["flash_wide"]["wgmma"]
        k["path"] = "main_mcg (c) (four-image mcg, bf16 exact)"
    state["main_mcg"] = results


def _split_sites(system, contexts, latent: int = 64):
    """The two halves of one UNet call (the input half, i_order; the mid and
    output walk), derived from the program: each half's flash launches by
    path (as ``_mc_launches``: every context's stack at every slot), its
    GroupNorm sites as [C, H, W] (the image data blocks' ResBlocks and
    output) and [C, N] (each context stack's norm), and its self-attention
    lengths. The GN sites of both halves must add up to ``_mc_gn``."""
    from vdtpu_torch.ops.flash import ATTN_WG_MAX_D
    d = system.model.diffuser
    prog = d["image"].program
    halves = [dict(flash={"wgmma": 0, "mma": 0}, gn=[], tokens=[]) for _ in range(2)]
    side, di, ci = latent, 0, 0
    for pos, tok in enumerate(prog.layer_order):
        half = halves[pos >= len(prog.i_order)]
        if tok == "d":
            spec = prog.data[di]
            if spec.kind == "res":
                half["gn"] += [(spec.in_ch, side, side), (spec.out_ch, side, side)]
            elif spec.kind == "out":
                half["gn"].append((spec.in_ch, side, side))
            side = side // 2 if spec.kind == "down" else side * 2 if spec.kind == "up" else side
            di += 1
        elif tok == "c":
            n = side * side
            for c_type, keys in contexts:
                cs = d[c_type].program.ctx[ci]
                half["gn"].append((cs.channels, n))
                path = "wgmma" if cs.dim_head <= ATTN_WG_MAX_D and cs.dim_head % 8 == 0 else "mma"
                half["flash"][path] += (n >= 1024) + (n >= 256 and keys >= 1024)
                half["tokens"].append(n)
            ci += 1
    n_gn = sum(len(h["gn"]) for h in halves)
    if n_gn != _mc_gn(system, [c for c, _ in contexts]):
        raise RuntimeError(f"split sites: {n_gn} GroupNorms derived, "
                           f"{_mc_gn(system, [c for c, _ in contexts])} in the modules")
    return halves


def _mode_expect(system, contexts, plan, vae_routes):
    """Flash launches by path and GN launches by route of one request
    whose UNet calls are ``plan``: (input half runs, batch) a step; the
    VAE's GN launches by route as read (``vae_routes``)."""
    import torch
    from vdtpu_torch.ops.gn_silu import _sm_count, gn_plan, gn_silu
    halves = _split_sites(system, contexts)
    flash = {"wgmma": 0, "mma": 0}
    gn = {k: vae_routes.get(k, 0) for k in gn_silu.launches_by_path}
    for encoder, batch in plan:
        for half in halves[0:2] if encoder else halves[1:]:
            for path, n in half["flash"].items():
                flash[path] += n
            for site in half["gn"]:
                gn[gn_plan((batch, *site), torch.bfloat16, 32, True, _sm_count(0)).route] += 1
    return flash, gn


def _vae_routes(system, with_encoder: bool, batch: int = 2) -> dict:
    """GN launches by route of one VAE decode of a ``batch``-image 64^2
    latent (and one encode of a 512^2 image), read from the counters; no
    flash launch."""
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    _zero_counters()
    with torch.no_grad():
        system.vae_decode(torch.zeros((batch, 64, 64, 4), device="cuda"), "image")
        if with_encoder:
            system.vae_encode(_i2i_image(SEED + 5), "image")
    torch.cuda.synchronize()
    if flash_attention.launches:
        raise RuntimeError(f"the VAE launched the flash kernel {flash_attention.launches} times")
    return dict(gn_silu.launches_by_path)


def _mode_requests(system):
    """(label, VDInference modes, call(vdi) -> (inputs shown, images), images
    shown, contexts as (c_type, keys), UNet calls as (input half runs,
    batch) a step, VAE encode) of main_modes' requests."""
    from vdtpu_torch.sampling.ddim import encoder_reuse_schedule
    prompt = "a red cat sitting on a wooden bench in the sun"
    text = [("text", 77)]
    t2i = lambda vdi: (None, vdi.inference_t2i(prompt, seed=SEED))
    images, mask = _mcg_inputs()
    tcg_request = lambda vdi: next(r for r in _mcg_requests(vdi, images, mask) if r[0] == "b")
    _, _, tcg_shown, tcg_ctx = tcg_request(None)
    tcg = lambda vdi: tcg_request(vdi)[1]()
    lo, hi = (int(round(f * STEPS)) for f in MODE_BAND)
    reuse = lambda steps: [(bool(k), 4) for k in encoder_reuse_schedule(steps, MODE_REUSE)]
    fid_steps = int(MODE_STEPS * (1 - 0.5))
    image = _i2i_image(SEED + 5)
    return (
        ("a", dict(ddim_steps=MODE_STEPS, sampler="dpmpp2m"), t2i, None, text,
         [(True, 4)] * MODE_STEPS, False),
        ("b", dict(ddim_steps=STEPS, encoder_reuse=MODE_REUSE), t2i, None, text,
         reuse(STEPS), False),
        ("c", dict(ddim_steps=STEPS, cfg_interval=MODE_BAND), t2i, None, text,
         [(True, 4 if lo <= i < hi else 2) for i in range(STEPS)], False),
        ("d", dict(ddim_steps=MODE_STEPS, sampler="dpmpp2m", encoder_reuse=MODE_REUSE), t2i,
         None, text, reuse(MODE_STEPS), False),
        ("e", dict(ddim_steps=STEPS, encoder_reuse=MODE_REUSE), tcg, tcg_shown, tcg_ctx,
         reuse(STEPS), False),
        ("f", dict(ddim_steps=MODE_STEPS, sampler="dpmpp2m"),
         lambda vdi: (None, vdi.inference_i2i(image, 0.5, 0.3, "Simple", seed=SEED)), None,
         [("image", 257)], [(True, 4)] * fid_steps, True))


def _equal_report(state, label: str, out, ref) -> dict:
    """Bit-equal, relative L2 and max |out - ref| of two card results; fails
    beyond MODE_MAX_REL_L2."""
    import torch
    a, b = out.float(), ref.float()
    rel = float((a - b).norm() / b.norm())
    r = dict(bit_equal=bool(torch.equal(out, ref)), rel_l2=rel,
             max_abs=float((a - b).abs().max()))
    log(f"main_modes {label}: bit-equal {r['bit_equal']}, rel_l2 {rel:.3e}, max |diff| "
        f"{r['max_abs']:.3e} (limit rel_l2 <= {MODE_MAX_REL_L2}) [{state.get('card')}]")
    if not (math.isfinite(rel) and rel <= MODE_MAX_REL_L2):
        raise RuntimeError(f"main_modes {label}: rel_l2 {rel} > {MODE_MAX_REL_L2}")
    return r


def phase_main_modes(state):
    import torch
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    base = dict(text_tokenizer=stand_in_tokenizer, output_dim=(512, 512), n_sample_image=2)
    vae = {enc: _vae_routes(system, enc) for enc in (False, True)}
    results = {}
    for label, modes, call, n_shown, contexts, plan, enc in _mode_requests(system):
        vdi = VDInference(system, **base, **modes)
        flash, gn = _mode_expect(system, contexts, plan, vae[enc])
        expect = {"flash_fwd": sum(flash.values()), "gn_silu": sum(gn.values())}
        batches = {b: sum(1 for _, bb in plan if bb == b) for b in sorted({b for _, b in plan})}
        log(f"main_modes ({label}) {modes}: {len(plan)} UNet calls, {sum(e for e, _ in plan)} "
            f"with the input half, by batch {batches}; expected flash by path {flash}, GN by "
            f"route {gn}")
        res = _mc_request(state, f"main_modes ({label})", lambda: call(vdi), n_shown, expect,
                          {"flash_fwd": flash, "nomax_fwd": {"wgmma": 0, "mma": 0}})
        for run, r in res.items():
            if r["gn_by_route"] != gn:
                raise RuntimeError(f"main_modes ({label}) {run}: GN by route "
                                   f"{r['gn_by_route']} != {gn}")
            results[f"{label}_{run}"] = dict(r, modes={k: str(v) for k, v in modes.items()},
                                             unet_calls_by_batch=batches)
    # one split walk at full width (the CFG batch of 4) against the full walk
    x, t, ctx = _eps_inputs(system, 4)
    with torch.no_grad():
        full = system.model.apply_model(x, t, ctx, "image", "text")
        split, cache = system.model.apply_model_encreuse(x, t, ctx, "image", "text", None, False)
        reused, _ = system.model.apply_model_encreuse(x, t, ctx, "image", "text", cache, True)
    torch.cuda.synchronize()
    results["split_walk"] = _equal_report(state, "split walk vs full walk", split, full)
    results["reused_cache"] = _equal_report(state, "decoder from the cache vs full walk",
                                            reused, full)
    del full, split, cache, reused
    # cfg_interval (0, 1) against plain CFG; the exact request's warm time
    prompt = "a red cat sitting on a wooden bench in the sun"
    imgs, secs = {}, {}
    for name, modes in (("exact", {}), ("band_0_1", dict(cfg_interval=(0.0, 1.0)))):
        vdi = VDInference(system, **base, ddim_steps=STEPS, **modes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[name] = vdi.inference_t2i(prompt, seed=SEED)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    results["cfg_interval_0_1"] = _equal_report(state, "cfg_interval=(0, 1) vs plain CFG",
                                                imgs["band_0_1"], imgs["exact"])
    results["exact_warm_s"] = secs["exact"]
    ratios = {label: results[f"{label}_once"]["seconds"] / secs["exact"] for label in "abcdef"}
    results["once_over_exact"] = ratios
    log(f"main_modes: exact t2i warm {secs['exact']:.3f} s (cfg_interval (0, 1): "
        f"{secs['band_0_1']:.3f} s); request (once, its first) / exact t2i: "
        f"{json.dumps({k: round(v, 4) for k, v in ratios.items()})} [{state.get('card')}]")
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            for label in "abcdef":
                state["kernels"][name][f"launches_modes_{label}"] = \
                    results[f"{label}_once"]["launches"][name]
    state["main_modes"] = results


def _eps_ref(state):
    """The eps calls' inputs on the bf16 system (x [1, 4, 64, 64] and the
    text context of "a red cat", bf16 on the card; t = 500) and the eps of
    its diffusers' f32 CPU copy on them: one full-width UNet call on the
    CPU, made once and shared by ``eps`` and ``main_f32`` (whose f32 system
    holds the same weights)."""
    import torch
    if "eps_ref" not in state:
        system = _system(state)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen).to(torch.bfloat16)
        t = torch.tensor([500], device="cuda")
        ctx = system.ctx_encode(stand_in_tokenizer(["a red cat"]), "text")
        t0 = time.perf_counter()
        cpu_model = _cpu_model(system)
        with torch.no_grad():
            eps_cpu = cpu_model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                            "image", "text")
        state["eps_ref"] = dict(x=x, t=t, ctx=ctx, eps_cpu=eps_cpu,
                                cpu_s=time.perf_counter() - t0)
    return state["eps_ref"]


def phase_eps(state):
    import torch
    system = _system(state)
    ref = _eps_ref(state)
    with torch.no_grad():
        eps_gpu = system.model.apply_model(ref["x"], ref["t"], ref["ctx"], "image",
                                           "text").float().cpu()
    dt, eps_cpu = ref["cpu_s"], ref["eps_cpu"]
    a, b = eps_gpu.flatten().double(), eps_cpu.flatten().double()
    cos = float(a @ b / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    log(f"eps: card bf16 vs cpu f32 at [1, 4, 64, 64]: cosine {cos:.6f} rel_l2 {rel:.5f} "
        f"(limits cos >= {EPS_MIN_COS}, rel_l2 <= {EPS_MAX_REL_L2}); cpu {dt:.1f} s (once, "
        f"shared with main_f32) [{state.get('card')}]")
    state["eps"] = dict(cosine=cos, rel_l2=rel)
    if not (math.isfinite(cos) and cos >= EPS_MIN_COS and rel <= EPS_MAX_REL_L2):
        raise RuntimeError("eps: card result disagrees with the f32 CPU result")


# ---- main_legacy -----------------------------------------------------------------------

def legacy_sites(model, batch: int, side: int = 0, ctx=None, which=None, xtype: str = "image"):
    """(GN input shapes, attention sites (queries, keys, heads, d_head)) of
    one call of a legacy family at ``batch``, walked from its layer
    program: a ResBlock's two norms (the second after its in-block
    resample), a transformer's norm on [B, C, N] and per block attn1 (on
    the context where self-attention is disabled) and attn2, the
    AttentionBlock's norm and self-attention, an FC block's two norms on
    [B, F, 1], the head's norm. ``side``: the input map's side (2-D
    streams); ``ctx``: the context length (None: no context, attn2 attends
    to the tokens), or the two lengths of a dual blend; ``which``: the dual
    branch (0 or 1) or None for a blend (a transformer layer given two
    lengths runs a stack on each, as ``forward_dc``); ``xtype``: the VD
    route."""
    from vdtpu_torch.models import legacy as L
    gn, attn = [], []
    if isinstance(model, L.LegacyUNetVD):
        model = model.unet_image if xtype == "image" else model.unet_text
    if isinstance(model, L.LegacyFCUNet):
        side = 0

    def stack(spec, n, kv):
        for _ in range(spec.depth):
            attn.append((n, kv if spec.disable_self else n, spec.heads, spec.dim_head))
            attn.append((n, n if kv is None else kv, spec.heads, spec.dim_head))

    def walk(specs, side, flat):
        for spec in specs:
            k = spec.kind
            n = side * side if side else (flat // spec.ch if flat else 1)
            if k in ("res", "res_up", "res_down"):
                gn.append((batch, spec.ch, side, side))
                side = side * 2 if k == "res_up" else side // 2 if k == "res_down" else side
                gn.append((batch, spec.out_ch, side, side))
            elif k in ("down", "pool"):
                side //= 2
            elif k in ("up", "nn_up"):
                side *= 2
            elif k == "attn":
                gn.append((batch, spec.ch, n))
                attn.append((n, n, spec.heads, spec.ch // spec.heads))
            elif k == "st":   # a pair of lengths: forward_dc runs two stacks
                for kv in (ctx if isinstance(ctx, tuple) else (ctx,)):
                    gn.append((batch, spec.ch, n))
                    stack(spec, n, kv)
            elif k == "dual":
                for branch in ((which,) if isinstance(which, int) else (0, 1)):
                    gn.append((batch, spec.ch, n))
                    stack(spec, n, ctx[branch] if isinstance(ctx, tuple) else ctx)
            elif k == "fc":
                gn.append((batch, spec.ch, 1))
                gn.append((batch, spec.out_ch, 1))
                flat = spec.out_ch if flat else 0
            elif k == "lin_in":
                flat = spec.out_ch
        return side, flat

    if isinstance(model, L.LegacyDecoderOnly):
        side, _ = walk([sp for st in model.program for sp in st], side, 0)
        gn.append((batch, model.out[0].weight.shape[0], side, side))
        return gn, attn
    ins, mid, outs = model.program
    md = isinstance(model, L.LegacyFCUNet) and model.second_dim is not None
    side, flat = walk([sp for st in (*ins, mid, *outs) for sp in st], side, 1 if md else 0)
    if isinstance(model, L.LegacyFCUNet):
        c = model.final_ch
        gn.append((batch, c, flat // c) if md else (batch, c, 1, 1))
    else:
        norm = model.id_predictor[0] if model.n_embed is not None else model.out[0]
        gn.append((batch, norm.weight.shape[0], side, side))
    return gn, attn


def _legacy_expect(sites, calls: int = 1) -> tuple[dict, dict]:
    """Flash launches by path and GN launches by route of ``calls`` calls
    whose sites are ``sites`` (``legacy_sites``), bf16: an attention site
    takes the flash kernel where ``pick_backend`` sends it (q >= 256, kv >=
    1024, d <= 256), the wgmma kernel for d <= ATTN_WG_MAX_D (the
    forward's limit) with d % 8 == 0 (every legacy site's q, k and v are
    16-byte aligned views), else mma.sync; each GN site the route of
    ``gn_plan``."""
    import torch
    from vdtpu_torch.ops.flash import ATTN_WG_MAX_D
    from vdtpu_torch.ops.gn_silu import _sm_count, gn_plan
    gn_shapes, attn = sites
    flash = {"wgmma": 0, "mma": 0}
    for q, kv, _, d in attn:
        if q >= 256 and kv >= 1024 and d <= 256:
            flash["wgmma" if d % 8 == 0 and d <= ATTN_WG_MAX_D else "mma"] += calls
    gn = {"resident": 0, "streaming": 0}
    for shape in gn_shapes:
        gn[gn_plan(shape, torch.bfloat16, 32, True, _sm_count(0)).route] += calls
    return flash, gn


@contextlib.contextmanager
def _recording_flash(calls: list, distinct: bool = False):
    """Record the (q, k, v) views of every call the attention dispatch makes
    to the flash kernel (held, not copied: their strides are the site's),
    calling through; with ``distinct`` only the first call of each site
    (shapes, strides, dtype), so a whole request holds no more than one
    set of views a site."""
    from vdtpu_torch.ops import attention
    inner = attention.flash_attention
    seen = set()

    def record(q, k, v, scale=None):
        sig = (tuple(q.shape), tuple(k.shape), q.stride(), k.stride(), str(q.dtype))
        if not (distinct and sig in seen):
            seen.add(sig)
            calls.append((q.detach(), k.detach(), v.detach()))
        return inner(q, k, v, scale)

    attention.flash_attention = record
    try:
        yield
    finally:
        attention.flash_attention = inner


def _flash_site_check(state, label: str, calls):
    """The flash kernel against its plain version at each distinct recorded
    site (shapes, strides, dtype), on that site's own q, k and v views,
    within the two-ulp band and ATTN_MAX_REL_L2 (f32 sites: the plain
    version with TF32 off, within F32_ATOL / F32_RTOL and F32_MAX_REL_L2);
    the path each takes."""
    import torch
    from vdtpu_torch.ops.flash import _plan_for, flash_attention, flash_attention_plain
    seen, rows = set(), []
    for q, k, v in calls:
        sig = (tuple(q.shape), tuple(k.shape), q.stride(), k.stride(), str(q.dtype))
        if sig in seen:
            continue
        seen.add(sig)
        f32 = q.dtype == torch.float32
        with _no_tf32():
            err, rel, ok = compare(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                                   *((F32_ATOL, F32_RTOL) if f32 else (ATOL, RTOL)))
        rows.append(dict(site=[list(q.shape), list(k.shape), list(q.stride())],
                         dtype=str(q.dtype).replace("torch.", ""),
                         path=_plan_for(q, k, v).path, max_abs_err=err, rel_l2_err=rel,
                         ok=ok and rel <= (F32_MAX_REL_L2 if f32 else ATTN_MAX_REL_L2)))
    torch.cuda.synchronize()
    bad = [r["site"] for r in rows if not r["ok"]]
    if rows:
        log(f"  site check flash_fwd ({label}): {len(rows)} distinct sites of {len(calls)} "
            f"calls, {[(r['site'], r['path']) for r in rows]}: max_abs_err "
            f"{max(r['max_abs_err'] for r in rows):.3e}, max rel_l2 "
            f"{max(r['rel_l2_err'] for r in rows):.3e}, disagreeing {bad} [{state.get('card')}]")
    if bad:
        raise RuntimeError(f"flash_fwd disagrees with its plain version at {label} sites {bad}")
    if rows and "flash_fwd" in state["kernels"]:
        k = state["kernels"]["flash_fwd"]
        k.setdefault("site_checks", {})[label] = rows
        k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in rows))
    return rows


def _legacy_build(cfg: dict, seed: int):
    """(f32 module, bf16 module) of a legacy config on the card: the port's
    seeded init with the zero-initialized tensors drawn from N(0, 0.02),
    the bf16 copy cast from the f32 weights."""
    import torch
    from vdtpu_torch.config.registry import build
    from vdtpu_torch.models.layers import init_random
    with torch.device("cuda"):
        f32 = build(cfg).eval().requires_grad_(False)
    init_random(f32, torch.Generator(device="cuda").manual_seed(seed))
    derandomize_zeros(f32, seed + 1)
    with torch.device("meta"):
        b16 = build(cfg).eval().requires_grad_(False).to(torch.bfloat16)
    b16.to_empty(device="cuda")
    b16.load_state_dict(f32.state_dict())
    return f32, b16


def _agreement(got, ref):
    """(cosine, relative L2) of two outputs, in f64."""
    a, b = got.flatten().double().cpu(), ref.flatten().double().cpu()
    return float(a @ b / (a.norm() * b.norm())), float((a - b).norm() / b.norm())


def _legacy_call(state, label: str, f32, b16, call, sites, f32_ref=None):
    """One bf16 call of ``b16`` with its flash and GN launches counted by
    path and route against ``sites`` (``legacy_sites``) and every distinct
    GN and flash site checked against its plain version; the output held
    to the f32 module's on the card (TF32 off, or ``f32_ref``) at
    EPS_MIN_COS / EPS_MAX_REL_L2. Returns a row for the log."""
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    gn_calls, fa_calls = [], []
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    with torch.no_grad(), _recording_gn(gn_calls), _recording_flash(fa_calls):
        out = call(b16, torch.bfloat16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {"flash_fwd": dict(flash_attention.launches_by_path), "gn_silu": _gn_routes(label)}
    for p in F32_PATHS:
        got["flash_fwd"].pop(p)
    flash, gn = _legacy_expect(sites)
    if got != {"flash_fwd": flash, "gn_silu": gn} or len(fa_calls) != sum(flash.values()):
        raise RuntimeError(f"{label}: launches {got} != derived {dict(flash_fwd=flash, gn_silu=gn)}")
    if f32_ref is None:
        with torch.no_grad(), _no_tf32():
            f32_ref = call(f32, torch.float32)
    cos, rel = _agreement(out.float(), f32_ref.float())
    ok = bool(torch.isfinite(out).all()) and cos >= EPS_MIN_COS and rel <= EPS_MAX_REL_L2
    log(f"  {label}: bf16 {tuple(out.shape)} in {dt * 1e3:.1f} ms (first call, GN inputs "
        f"recorded), against f32: "
        f"cosine {cos:.7f} rel_l2 {rel:.6f} (limits cos >= {EPS_MIN_COS}, rel_l2 <= "
        f"{EPS_MAX_REL_L2}); launches {got} as derived [{state.get('card')}]")
    if not ok:
        raise RuntimeError(f"{label}: bf16 output disagrees with f32 (cos {cos}, rel {rel})")
    _gn_site_check(state, label, gn_calls)
    _flash_site_check(state, label, fa_calls)
    del gn_calls, fa_calls
    t0 = time.perf_counter()
    with torch.no_grad():
        call(b16, torch.bfloat16)
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    log(f"  {label}: warm bf16 call {warm:.1f} ms (host clock, eager) [{state.get('card')}]")
    return dict(ms_cold=dt * 1e3, ms_warm=warm, cosine=cos, rel_l2=rel, launches=got)


def _legacy_vd_cfg(bank) -> dict:
    """VD v1's two trunks: openai_unet_2d_v1's and openai_unet_0d_v1's args
    less ``parts`` (the port's bank holds the latter as its
    openai_unet_0d_v1_dc, the same args with parts [data, context])."""
    strip = lambda name: {k: v for k, v in bank(name)["args"].items() if k != "parts"}
    return {"type": "openai_unet_vd",
            "args": {"unet_image_cfg": {"type": "openai_unet_2d",
                                        "args": strip("openai_unet_2d_v1")},
                     "unet_text_cfg": {"type": "openai_unet_0dmd",
                                       "args": strip("openai_unet_0d_v1_dc")}}}


def _legacy_vd(state, system) -> dict:
    """(a) UNetModelVD at VD v1's widths: a t2i request (the port's CLIP text
    tower on the prompt and "", cfg_eps_fn + ddim_loop over the image route,
    DDIM-50 at CFG 7.5, n = 2, KL-f8 decode to 512^2) cold then warm, the
    text route sampled 50 steps on [2, 768] latents, then one eps call a
    route and forward_dc: the image route against f32 on the CPU, the
    others against f32 on the card; launches derived and asserted."""
    import torch
    from vdtpu_torch.config.configs import model_cfg_bank
    from vdtpu_torch.config.registry import build
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    from vdtpu_torch.sampling.ddim import DDIMTables, cfg_eps_fn, ddim_loop
    cfg = _legacy_vd_cfg(model_cfg_bank())
    t0 = time.perf_counter()
    f32, b16 = _legacy_build(cfg, SEED + 20)
    n_params = sum(p.numel() for p in b16.parameters())
    log(f"main_legacy (a): openai_unet_vd at VD v1's widths, {n_params / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    prompt = "a red cat sitting on a wooden bench in the sun"
    n = 2
    cond = system.ctx_encode(stand_in_tokenizer([prompt] * n), "text")
    uncond = system.ctx_encode(stand_in_tokenizer([""] * n), "text")
    vision = system.ctx_encode(_i2i_image(SEED + 21).expand(n, -1, -1, -1), "image")
    tables = DDIMTables.create(system.model.schedule, STEPS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x_img = torch.randn(n, 4, 64, 64, device="cuda", generator=gen).to(torch.bfloat16)
    x_txt = torch.randn(n, 768, device="cuda", generator=gen).to(torch.bfloat16)
    vae_routes = _vae_routes(system, False, n)
    vae_gn = sum(vae_routes.values())
    res = {}

    def request(xtype, x):
        eps = cfg_eps_fn(lambda xx, tt, cc: b16(xx, tt, cc, xtype=xtype, ctype="prompt"),
                         cond, uncond, 7.5)
        z = ddim_loop(eps, x, tables)
        return system.vae_decode(z.permute(0, 2, 3, 1), "image") if xtype == "image" else z

    for run, xtype, x in (("t2i cold", "image", x_img), ("t2i warm", "image", x_img),
                          ("text route", "text", x_txt)):
        flash, gn = _legacy_expect(legacy_sites(b16, 2 * n, 64, 77, xtype=xtype), STEPS)
        if xtype == "image":
            gn = {r: gn[r] + vae_routes.get(r, 0) for r in gn}
        torch.cuda.synchronize()
        _zero_counters()
        t = time.perf_counter()
        with torch.no_grad():
            out = request(xtype, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = {"flash_fwd": {p: c for p, c in flash_attention.launches_by_path.items()
                             if p not in F32_PATHS}, "gn_silu": _gn_routes(f"main_legacy {run}")}
        want_shape = (n, 512, 512, 3) if xtype == "image" else (n, 768)
        fine = bool(torch.isfinite(out).all()) and tuple(out.shape) == want_shape
        if xtype == "image":
            fine = fine and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
        log(f"main_legacy (a) {run}: {dt:.3f} s, shape {tuple(out.shape)} finite/range ok "
            f"{fine}, launches {got} (derived {dict(flash_fwd=flash, gn_silu=gn)}; the VAE's GN "
            f"{vae_gn}) [{state.get('card')}]")
        if not fine:
            raise RuntimeError(f"main_legacy (a) {run}: bad output")
        if got != {"flash_fwd": flash, "gn_silu": gn}:
            raise RuntimeError(f"main_legacy (a) {run}: launches {got} != derived")
        res[run] = dict(seconds=dt, launches=got, flash=flash_attention.launches,
                        gn=gn_silu.launches)
    t_ = torch.full((n,), 500, device="cuda")
    cpu = _cpu_f32(b16, lambda: build(cfg))
    t = time.perf_counter()
    with torch.no_grad():
        cpu_img = cpu(x_img[:1].float().cpu(), t_[:1].cpu(), cond[:1].float().cpu(),
                      xtype="image", ctype="prompt")
    log(f"main_legacy (a): the image route in f32 on the CPU at batch 1: "
        f"{time.perf_counter() - t:.1f} s")
    del cpu
    routes = [("image", "prompt", x_img, cond), ("image", "vision", x_img, vision),
              ("text", "prompt", x_txt, cond), ("text", "vision", x_txt, vision)]
    for xtype, ctype, x, c in routes:
        sites = legacy_sites(b16, n, 64, c.shape[1], xtype=xtype)
        call = lambda m, dt, x=x, c=c, xtype=xtype, ctype=ctype: m(
            x.to(dt), t_, c.to(dt), xtype=xtype, ctype=ctype)
        if xtype == "image" and ctype == "prompt":   # batch 1 against the CPU
            call1 = lambda m, dt: m(x_img[:1].to(dt), t_[:1], cond[:1].to(dt), xtype="image",
                                    ctype="prompt")
            res["eps image/prompt (cpu f32)"] = _legacy_call(
                state, "main_legacy (a) eps image/prompt, f32 on the CPU", f32, b16, call1,
                legacy_sites(b16, 1, 64, 77), f32_ref=cpu_img)
        res[f"eps {xtype}/{ctype}"] = _legacy_call(
            state, f"main_legacy (a) eps {xtype}/{ctype}", f32, b16, call, sites)
    for xtype, x in (("image", x_img), ("text", x_txt)):
        # forward_dc: both contexts' stacks run at every context layer
        sites = legacy_sites(b16, n, 64, (vision.shape[1], cond.shape[1]), xtype=xtype)
        call = lambda m, dt, x=x, xtype=xtype: m.forward_dc(
            x.to(dt), t_, vision.to(dt), cond.to(dt), xtype, "vision", "prompt", LEGACY_DC_RATIO)
        res[f"forward_dc {xtype}"] = _legacy_call(
            state, f"main_legacy (a) forward_dc {xtype} r={LEGACY_DC_RATIO}", f32, b16, call,
            sites)
    del f32, b16
    torch.cuda.empty_cache()
    return res


def _legacy_families(state, system) -> dict:
    """(b) every other family, one bf16 eps call each at batch 2 (the CFG
    size) at published widths, built one at a time and freed after: each
    against f32 on the card, every GN and flash site against its plain
    version, launches derived and asserted."""
    import torch
    from vdtpu_torch.config.configs import model_cfg_bank
    bank = model_cfg_bank()
    vd = _legacy_vd_cfg(bank)["args"]
    img, txt = vd["unet_image_cfg"]["args"], vd["unet_text_cfg"]["args"]
    b = LEGACY_BATCH
    u = system.ctx_encode(stand_in_tokenizer([""]), "text")
    c = system.ctx_encode(stand_in_tokenizer(["a red cat sitting on a wooden bench"]), "text")
    text = torch.cat([u, c])                                    # [2, 77, 768]
    image = system.ctx_encode(_i2i_image(SEED + 23).expand(b, -1, -1, -1), "image")  # 257
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    lat = torch.randn(b, 4, 64, 64, device="cuda", generator=gen)
    px = torch.randn(b, 3, 256, 256, device="cuda", generator=gen)
    flat = torch.randn(b, 768, device="cuda", generator=gen)
    y = torch.tensor([1, 207], device="cuda")
    t = torch.full((b,), 500, device="cuda")
    nc = {k: v for k, v in LEGACY_SD_V1.items() if k != "context_dim"}
    noatt = {k: LEGACY_SD_V1[k] for k in ("image_size", "in_channels", "out_channels",
                                          "model_channels", "num_res_blocks", "channel_mult",
                                          "use_checkpoint")}
    cases = [   # (label, type, args, [(call label, call, sites arguments)])
        ("openai_unet SD v1", "openai_unet", LEGACY_SD_V1,
         [("", lambda m, dt: m(lat.to(dt), t, text.to(dt)), dict(side=64, ctx=77))]),
        ("openai_unet ADM-256", "openai_unet", LEGACY_ADM_256,
         [("", lambda m, dt: m(px.to(dt), t, None, y), dict(side=256))]),
        ("openai_unet_dual_context SD v1", "openai_unet_dual_context", LEGACY_SD_V1,
         [("which 0", lambda m, dt: m(lat.to(dt), t, text.to(dt), which_attn=0),
           dict(side=64, ctx=77, which=0)),
          ("which 1", lambda m, dt: m(lat.to(dt), t, image.to(dt), which_attn=1),
           dict(side=64, ctx=257, which=1)),
          (f"blend {LEGACY_DC_RATIO}", lambda m, dt: m(lat.to(dt), t, (text.to(dt), image.to(dt)),
                                                       which_attn=LEGACY_DC_RATIO),
           dict(side=64, ctx=(77, 257)))]),
        ("openai_unet_nocontext SD v1", "openai_unet_nocontext", nc,
         [("", lambda m, dt: m(lat.to(dt), t), dict(side=64))]),
        ("openai_unet_nocontext_noatt SD v1", "openai_unet_nocontext_noatt", noatt,
         [("", lambda m, dt: m(lat.to(dt), t), dict(side=64))]),
        ("decoder-only defaults", "openai_unet_nocontext_noatt_decoderonly", {},
         [("", lambda m, dt: m(lat.to(dt), t), dict(side=64))]),
        ("openai_unet_2d VD v1", "openai_unet_2d", img,
         [("", lambda m, dt: m(lat.to(dt), t, text.to(dt)), dict(side=64, ctx=77))]),
        ("openai_unet_0d VD v1", "openai_unet_0d",
         {k: v for k, v in txt.items() if k != "second_dim"},
         [("", lambda m, dt: m(flat.to(dt), t, text.to(dt)), dict(ctx=77))]),
        ("openai_unet_0dmd VD v1", "openai_unet_0dmd", txt,
         [("", lambda m, dt: m(flat.to(dt), t, text.to(dt)), dict(ctx=77))]),
    ]
    res = {}
    for i, (label, kind, args, calls) in enumerate(cases):
        t0 = time.perf_counter()
        f32, b16 = _legacy_build({"type": kind, "args": dict(args)}, SEED + 30 + i)
        n_params = sum(p.numel() for p in b16.parameters())
        log(f"main_legacy (b) {label}: {n_params / 1e6:.1f} M params, built in "
            f"{time.perf_counter() - t0:.1f} s")
        outs = []
        for name, call, where in calls:
            key = f"{label} {name}".strip()
            res[key] = _legacy_call(state, f"main_legacy (b) {key}", f32, b16, call,
                                    legacy_sites(b16, b, **where))
            with torch.no_grad():
                outs.append(call(b16, torch.bfloat16).float())
        if len(outs) > 1:   # the dual family: each which_attn gives its own output
            apart = [float((o - outs[0]).norm() / outs[0].norm()) for o in outs[1:]]
            log(f"  main_legacy (b) {label}: outputs apart from the first call's by relative "
                f"L2 {apart} [{state.get('card')}]")
            if min(apart) < LEGACY_DC_APART:
                raise RuntimeError(f"main_legacy (b) {label}: which_attn changed nothing {apart}")
        del f32, b16, outs
        torch.cuda.empty_cache()
    return res


def _legacy_vd_inference(state, system) -> dict:
    """(c) ``vd_inference(fp16=True, checkpoint=...)`` on a seeded bf16
    checkpoint of vd_four_flow_v1-0 (the serving system's weights under
    ``state_dict``, torch.save'd into memory: a call may write 45 GiB to
    the disk and main_launch writes most of it), its t2i request against
    the same request on the serving system, which loads the same dict
    directly: bit-equal."""
    import gc
    import io
    import torch
    from vdtpu_torch.serving.api import VDInference, vd_inference
    t0 = time.perf_counter()
    sd = {k: v.to("cpu", torch.bfloat16) for k, v in system.net.state_dict().items()}
    buf = io.BytesIO()
    torch.save({"state_dict": sd}, buf)
    size = buf.tell()
    buf.seek(0)
    t1 = time.perf_counter()
    kw = dict(text_tokenizer=stand_in_tokenizer, output_dim=(512, 512), ddim_steps=STEPS,
              n_sample_image=2)
    vdi = vd_inference(fp16=True, checkpoint=buf, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del buf
    dtypes = {str(p.dtype) for p in vdi.sys.net.parameters()}
    missing = system.load_torch_checkpoint(sd)
    direct = VDInference(system, **kw)
    prompt = "a red cat sitting on a wooden bench in the sun"
    out = vdi.inference_t2i(prompt, seed=SEED)
    t3 = time.perf_counter()
    ref = direct.inference_t2i(prompt, seed=SEED)
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    log(f"main_legacy (c) vd_inference(fp16=True, checkpoint=<{size / 2**30:.2f} GiB .pt>): "
        f"saved in {t1 - t0:.1f} s, built and loaded in {t2 - t1:.1f} s on "
        f"{vdi.sys.device}, parameter dtypes {sorted(dtypes)}; t2i {t3 - t2:.2f} s; bit-equal to "
        f"the serving system's request on the same dict {equal} (its direct load missed "
        f"{len(missing)} keys) [{state.get('card')}]")
    if not equal or dtypes != {"torch.bfloat16"} or missing or vdi.sys.device.type != "cuda":
        raise RuntimeError("main_legacy (c): vd_inference differs from a direct load")
    del vdi, sd
    gc.collect()
    torch.cuda.empty_cache()
    return dict(checkpoint_gib=size / 2**30, save_s=t1 - t0, build_load_s=t2 - t1,
                t2i_s=t3 - t2, bit_equal=equal)


def phase_main_legacy(state):
    """The legacy diffuser zoo at published widths: (a) UNetModelVD at VD
    v1's widths (a t2i request, the text route, every route and
    forward_dc), (b) every other family, (c) vd_inference."""
    import torch
    system = _system(state)
    t0 = time.perf_counter()
    res = {"a": _legacy_vd(state, system)}
    t1 = time.perf_counter()
    res["b"] = _legacy_families(state, system)
    t2 = time.perf_counter()
    res["c"] = _legacy_vd_inference(state, system)
    log(f"main_legacy: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s [{state.get('card')}]")
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            state["kernels"][name]["legacy_launches"] = {
                "t2i warm": res["a"]["t2i warm"]["launches"][name],
                "text route": res["a"]["text route"]["launches"][name]}
    torch.cuda.empty_cache()
    state["main_legacy"] = res


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


def _int8_sites(system, c_type: str = "text"):
    """(calibrated int8 conv sites of the image data blocks, those of them
    that are ResBlock convs behind a GroupNorm, QDense sites of the
    ``c_type`` diffuser's context blocks): each runs once per UNet call."""
    from vdtpu_torch.models.blocks import ResBlock2D
    from vdtpu_torch.ops.quant import QConv, QDense
    img, txt = system.model.diffuser["image"], system.model.diffuser[c_type]
    convs = sum(isinstance(m, QConv) and m.act_scale is not None
                for m in img.data_blocks.modules())
    gn_convs = sum(conv.act_scale is not None for m in img.data_blocks.modules()
                   if isinstance(m, ResBlock2D) for conv in (m.in_layers[2], m.out_layers[3]))
    mms = sum(isinstance(m, QDense) and m.w_q is not None for m in txt.context_blocks.modules())
    return convs, gn_convs, mms


def _gnq_sites(system, batch: int, min_pixels: int | None = None, latent: int = 64):
    """[B, C, side, side] of every ResBlock GroupNorm whose conv runs int8
    on a calibrated scale, on maps of at least the policy's min_pixels (or
    ``min_pixels``; conv="fused" takes fused_min_pixels), in program order:
    the int8 GN kernels' calls of one UNet call at batch ``batch``."""
    from vdtpu_torch.ops.quant import QuantPolicy
    unet = system.model.diffuser["image"]
    floor = QuantPolicy().min_pixels if min_pixels is None else min_pixels
    side, di, out = latent, 0, []
    for tok in unet.program.layer_order:
        if tok != "d":
            continue
        spec, block = unet.program.data[di], unet.data_blocks[di][0]
        if spec.kind == "res" and side * side >= floor:
            for conv, ch in ((block.in_layers[2], spec.in_ch), (block.out_layers[3], spec.out_ch)):
                if conv.act_scale is not None:
                    out.append((batch, ch, side, side))
        side = side // 2 if spec.kind == "down" else side * 2 if spec.kind == "up" else side
        di += 1
    return out


def _gnq_expected(sites, stats: bool, calls: int = 1) -> dict:
    """Launches by gnq_plan route of ``calls`` UNet calls' int8 GN sites
    (the bf16 system's), over every route of the wrapper."""
    import torch
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_stats, gnq_plan
    from vdtpu_torch.ops.qconv import sm_count
    out = dict.fromkeys((gn_stats if stats else gn_silu_q).launches_by_route, 0)
    for shape in sites:
        out[gnq_plan(shape, torch.bfloat16, 32, sm_count(0), stats).route] += calls
    return out


def _gnq_routes() -> dict:
    """The int8 GN wrappers' launches by route since their counters were
    zeroed; raises unless every launch took one of their routes."""
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_stats
    out = {}
    for name, fn in (("gn_silu_q", gn_silu_q), ("gn_stats", gn_stats)):
        out[name] = dict(fn.launches_by_route)
        if sum(out[name].values()) != fn.launches:
            raise RuntimeError(f"{name} launches by route {out[name]} of {fn.launches}")
    return out


def _int8_launches(system, tome_ratio: float | None, c_types=("text",), steps: int = STEPS):
    """Launches of one int8 request whose contexts (one stack each, of
    ``c_types``) have fewer than 1024 keys, derived from the program: per
    UNet call (x ``steps``) every calibrated conv site of the image data
    blocks runs the int8 conv kernel; every QDense of each stack's context
    blocks one torch._int_mm; every self-attention whose (merged) length reaches
    the flash rule (q >= 256, kv >= 1024) the no-max kernel, once a stack,
    and nothing the exact flash kernel (every such site has a shift; the
    cross-attentions take the plain path); the GroupNorms and the VAE
    decoder as in the bf16 request. Also the no-max launches by kv length:
    ToMe merges each 4096-token site to 4096 - merge_count."""
    from vdtpu_torch.ops.tome import merge_count
    convs, _, _ = _int8_sites(system)
    by_kv = {}
    for n in _ctx_tokens(system.model.diffuser["image"], 64):
        if tome_ratio is not None and n >= 4096:
            n -= merge_count(n, tome_ratio)
        if n >= 1024:
            by_kv[n] = by_kv.get(n, 0) + steps * len(c_types)
    _, vae_gn, _ = _gn_sites(system)
    return {"flash_fwd": 0, "nomax_fwd": sum(by_kv.values()), "qconv3": convs * steps,
            "int_mm": sum(_int8_sites(system, c)[2] for c in c_types) * steps,
            "gn_silu": _mc_gn(system, c_types) * steps + vae_gn}, by_kv


def _counters():
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_q, gn_stats
    from vdtpu_torch.ops.nomax import flash_attention_nomax
    from vdtpu_torch.ops.qconv import qconv3, qconv3_gn, resblock_q
    from vdtpu_torch.ops.quant import int8_linear
    return {"flash_fwd": flash_attention, "nomax_fwd": flash_attention_nomax,
            "qconv3": qconv3, "qconv3_gn": qconv3_gn, "resblock_q": resblock_q,
            "int_mm": int8_linear, "gn_silu": gn_silu, "gn_silu_q": gn_silu_q,
            "gn_stats": gn_stats}


def _zero_counters(*extra):
    """Zero the launch counts (and counts by path, route and kv length) of
    every wrapper in ``_counters`` and of ``extra``."""
    for fn in (*_counters().values(), *extra):
        fn.launches = 0
        for by in (getattr(fn, "launches_by_path", {}), getattr(fn, "launches_by_route", {}),
                   getattr(fn, "launches_wide", {})):
            for key in by:
                by[key] = 0
    _counters()["nomax_fwd"].launches_by_kv.clear()


def _plan_paths(calls, label: str) -> dict:
    """Launches by qconv3_plan path of one UNet call's recorded int8 conv
    calls (the site check's recording)."""
    from vdtpu_torch.ops.qconv import qconv3_plan
    paths = {"halo": 0, "general": 0}
    for args, _ in calls:
        if label == "qconv3":   # xq [B, H, W, C], wq [N, 3, 3, C], ..., stride
            (b, h, w, c), n, stride = args[0].shape, args[1].shape[0], args[5]
        else:                   # x [B, C, H, W], ..., wq, ..., stride at 9
            (b, c, h, w), n, stride = args[0].shape, args[5].shape[0], args[9]
        paths[qconv3_plan(b, h, w, c, n, stride, label == "qconv3_gn").path] += 1
    return paths


def _read_counters():
    return {k: fn.launches for k, fn in _counters().items()}


def _gn_routes(label: str) -> dict:
    """Launches of the GN kernel by gn_plan route since its counters were
    zeroed; raises unless every launch took one of the two routes."""
    from vdtpu_torch.ops.gn_silu import gn_silu
    by = dict(gn_silu.launches_by_path)
    if sum(by.values()) != gn_silu.launches:
        raise RuntimeError(f"{label}: gn_silu launches by route {by} of {gn_silu.launches}")
    return by


def _attn_paths(label: str) -> dict:
    """Launches by ``attn_fwd_plan`` path of the two attention forwards since
    their counters were zeroed; raises unless they add up. The f32 paths
    are listed only where they launched (the bf16 paths' expectations name
    the two tensor-core kernels)."""
    c = _counters()
    paths = {name: {p: n for p, n in c[name].launches_by_path.items()
                    if p not in F32_PATHS or n}
             for name in ("flash_fwd", "nomax_fwd")}
    for name, by in paths.items():
        if sum(by.values()) != c[name].launches:
            raise RuntimeError(f"{label}: {name} launches by path {by} of {c[name].launches}")
    return paths


def _wgmma_only(label: str) -> dict:
    """``_attn_paths``; raises unless every launch took the wgmma kernel (the
    single-context paths' heads of 40 and 80 on aligned projections)."""
    paths = _attn_paths(label)
    for name, by in paths.items():
        if sum(by.values()) != by["wgmma"]:
            raise RuntimeError(f"{label}: {name} launches by path {by}; every "
                               "launch of this path must take the wgmma kernel")
    return paths


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
    calib_s = _calibrate(state, system, "main_int8")
    # every int8 conv site of the request (one CFG UNet call at batch 4 on
    # the 64^2 latent) against the plain version, on its own arguments
    calls = []
    xs, ts, cs = _eps_inputs(system, 4)
    with torch.no_grad(), _recording("qconv3", calls):
        system.model.apply_model(xs, ts, cs, "image", "text")
    _site_check(state, "qconv3", calls, qconv3, qconv3_plain)
    # the request's UNet calls run the same sites at batch 2 x CFG = 4
    expect_paths = {k: v * STEPS for k, v in _plan_paths(calls, "qconv3").items()}
    # the input half's sites come first in the recording
    n_in = _int8_split_sites(system)[0]["qconv3"]
    half_paths = [_plan_paths(calls[:n_in], "qconv3"), _plan_paths(calls[n_in:], "qconv3")]
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
            for run in ONCE:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counters()
                t = time.perf_counter()
                img = vdi.inference_t2i(prompt, seed=SEED)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                got, by_kv = _read_counters(), dict(by_kv_now)
                paths = dict(qconv3.launches_by_path)
                attn_paths = _wgmma_only(f"main_int8 {mode} {run}")
                counts = {k: got[k] for k in expect}
                peak = torch.cuda.max_memory_allocated() / 2**30
                finite = bool(torch.isfinite(img).all())
                lo, hi = float(img.min()), float(img.max())
                log(f"main_int8 {mode} {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak "
                    f"{peak:.2f} GiB, shape {tuple(img.shape)} finite {finite} range "
                    f"[{lo:.4f}, {hi:.4f}], launches {counts} (expected {expect}), no-max by "
                    f"kv length {by_kv} (expected {expect_kv}), int8 conv by path {paths} "
                    f"(expected {expect_paths}), attention by path {attn_paths} "
                    f"[{state.get('card')}]")
                if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0
                        and hi <= 1.0):
                    raise RuntimeError(f"main_int8 {mode} {run}: bad output")
                if (counts != expect or got["qconv3_gn"] or got["gn_silu_q"] or got["gn_stats"]
                        or got["resblock_q"]):
                    raise RuntimeError(f"main_int8 {mode} {run}: launch counts {got} != {expect}")
                if by_kv != expect_kv:
                    raise RuntimeError(f"main_int8 {mode} {run}: no-max launches by kv length "
                                       f"{by_kv} != {expect_kv}")
                if paths != expect_paths:
                    raise RuntimeError(f"main_int8 {mode} {run}: int8 conv launches by path "
                                       f"{paths} != {expect_paths}")
                results[f"{mode}_{run}"] = dict(seconds=dt, images_per_s=2 / dt, peak_gib=peak,
                                                launches=counts, nomax_by_kv=by_kv,
                                                qconv3_by_path=paths,
                                                attention_by_path=attn_paths)
        # main_mcg's tcg request (b) under the default serving policy, int8 +
        # ToMe: both context stacks on the int8 sites, the contexts' 77 and
        # 514 keys on the plain path
        system.enable_tome(TOME_RATIO)
        (_, call, n_shown, contexts), = [r for r in _mcg_requests(vdi, *_mcg_inputs())
                                         if r[0] == "b"]
        expect, expect_kv = _int8_launches(system, TOME_RATIO, [c for c, _ in contexts])
        res = _mc_request(state, "main_int8 tcg int8_tome", call, n_shown, expect,
                          {"flash_fwd": {"wgmma": 0, "mma": 0},
                           "nomax_fwd": {"wgmma": expect["nomax_fwd"], "mma": 0}}, expect_kv)
        for run, r in res.items():
            results[f"tcg_int8_tome_{run}"] = r
        # t2i under int8 + ToMe and encoder reuse: the split walk's halves
        vdi_reuse = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                                ddim_steps=STEPS, n_sample_image=2, encoder_reuse=MODE_REUSE)
        expect, expect_kv, expect_paths = _int8_reuse_launches(system, TOME_RATIO, half_paths)
        res = _mc_request(state, "main_int8 t2i int8_tome encoder_reuse",
                          lambda: (None, vdi_reuse.inference_t2i(prompt, seed=SEED)), None,
                          expect, {"flash_fwd": {"wgmma": 0, "mma": 0},
                                   "nomax_fwd": {"wgmma": expect["nomax_fwd"], "mma": 0}},
                          expect_kv)
        paths = dict(qconv3.launches_by_path)   # the request's
        log(f"main_int8 t2i int8_tome encoder_reuse: int8 conv by path {paths} (expected "
            f"{expect_paths}) [{state.get('card')}]")
        if paths != expect_paths:
            raise RuntimeError(f"main_int8 encoder_reuse: int8 conv launches by path {paths} "
                               f"!= {expect_paths}")
        for run, r in res.items():
            results[f"t2i_int8_tome_reuse_{run}"] = dict(r, qconv3_by_path=paths)
    finally:
        system.enable_tome(0)
    for name in ("nomax_fwd", "qconv3"):
        if name in state["kernels"]:
            state["kernels"][name]["launches"] = results["int8_once"]["launches"][name]
            state["kernels"][name]["path"] = "main_int8 (int8 request)"
    if "qconv3" in state["kernels"]:
        state["kernels"]["qconv3"]["launches_by_path"] = results["int8_once"]["qconv3_by_path"]
    if "nomax_fwd" in state["kernels"]:
        state["kernels"]["nomax_fwd"]["launches_by_path"] = \
            results["int8_once"]["attention_by_path"]["nomax_fwd"]
    state["main_int8"] = results


def _int8_split_sites(system):
    """Per half of one int8 UNet call (t2i), from the program: the
    calibrated int8 conv sites of the image data blocks and the QDense sites
    of the text diffuser's context blocks on each side of the input half's
    end."""
    from vdtpu_torch.ops.quant import QConv, QDense
    d = system.model.diffuser
    n_d, n_c = d["image"]._encoder_counts()
    convs = lambda blocks: sum(isinstance(m, QConv) and m.act_scale is not None
                               for m in blocks.modules())
    mms = lambda blocks: sum(isinstance(m, QDense) and m.w_q is not None
                             for m in blocks.modules())
    data, ctx = d["image"].data_blocks, d["text"].context_blocks
    return [dict(qconv3=convs(data[:n_d]), int_mm=mms(ctx[:n_c])),
            dict(qconv3=convs(data[n_d:]), int_mm=mms(ctx[n_c:]))]


def _int8_reuse_launches(system, tome_ratio: float | None, half_paths, steps: int = STEPS,
                         interval: int = MODE_REUSE):
    """Launches of an int8 (+ ToMe) t2i request under encoder reuse
    (``steps`` steps, the input half on the key steps of
    encoder_reuse_schedule at ``interval``, warmup 5), as ``_int8_launches``
    a half; the int8 conv's launches by path from each half's recorded sites
    (``half_paths``; None: not derived)."""
    from vdtpu_torch.ops.tome import merge_count
    from vdtpu_torch.sampling.ddim import encoder_reuse_schedule
    keys = int(encoder_reuse_schedule(steps, interval).sum())
    calls = (keys, steps)   # input half, mid and output walk
    half_paths = half_paths or [{}, {}]
    halves = _split_sites(system, [("text", 77)])
    sites = _int8_split_sites(system)
    _, vae_gn, _ = _gn_sites(system)
    expect = {"flash_fwd": 0, "nomax_fwd": 0, "qconv3": 0, "int_mm": 0, "gn_silu": vae_gn}
    by_kv, paths = {}, {"halo": 0, "general": 0}
    for half, site, hp, n_calls in zip(halves, sites, half_paths, calls):
        expect["qconv3"] += site["qconv3"] * n_calls
        expect["int_mm"] += site["int_mm"] * n_calls
        expect["gn_silu"] += len(half["gn"]) * n_calls
        for n in half["tokens"]:
            if tome_ratio and n >= 4096:
                n -= merge_count(n, tome_ratio)
            if n >= 1024:
                by_kv[n] = by_kv.get(n, 0) + n_calls
        for k, v in hp.items():
            paths[k] += v * n_calls
    expect["nomax_fwd"] = sum(by_kv.values())
    return expect, by_kv, paths


def _calibrate(state, system, label: str) -> float:
    """enable_int8 over vdtpu's four flows, timed (a no-op, reported as
    such, when an earlier phase calibrated the system)."""
    import torch
    from vdtpu_torch.serving.api import FOUR_FLOWS
    if "calibration_s" in state:
        log(f"{label}: calibrated by an earlier phase in {state['calibration_s']:.3f} s")
        return state["calibration_s"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    system.enable_int8(image_size=512, n=2)
    torch.cuda.synchronize()
    state["calibration_s"] = time.perf_counter() - t
    log(f"{label}: enable_int8(image_size=512, n=2) over the four flows {FOUR_FLOWS}: "
        f"calibration {state['calibration_s']:.3f} s [{state.get('card')}]")
    return state["calibration_s"]


def _fused2_sites(system, latent: int = 64):
    """(C_in, C_out, side) of every ResBlock that conv="fused2" runs as one
    kernel in a UNet call on a latent of side ``latent``, derived from the
    program: a 2-D ResBlock whose map has at least fused_min_pixels pixels
    and 8-aligned sizes and whose two convs carry calibrated tables."""
    from vdtpu_torch.ops.quant import QuantPolicy
    unet = system.model.diffuser["image"]
    pol, side, di, out = QuantPolicy(), latent, 0, []
    for tok in unet.program.layer_order:
        if tok != "d":
            continue
        spec = unet.program.data[di]
        block = unet.data_blocks[di][0]
        if (spec.kind == "res" and side * side >= pol.fused_min_pixels and side % 8 == 0
                and spec.in_ch % 8 == 0 and spec.out_ch % 8 == 0
                and block.in_layers[2].act_scale is not None
                and block.out_layers[3].act_scale is not None):
            out.append((spec.in_ch, spec.out_ch, side))
        side = side // 2 if spec.kind == "down" else side * 2 if spec.kind == "up" else side
        di += 1
    return out


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
    sites = _gnq_sites(system, x.shape[0])
    fused_sites = _gnq_sites(system, x.shape[0], QuantPolicy().fused_min_pixels)
    no_q, no_st = _gnq_expected([], False), _gnq_expected([], True)
    # each mode's int8 GN launches by route: one launch a site, on its plan's route
    want_routes = {"gn_prologue=fused": {"gn_silu_q": _gnq_expected(sites, False),
                                         "gn_stats": no_st},
                   "gn_prologue=stats": {"gn_silu_q": no_q,
                                         "gn_stats": _gnq_expected(sites, True)},
                   "conv=fused": {"gn_silu_q": no_q,
                                  "gn_stats": _gnq_expected(fused_sites, True)}}
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
            _wgmma_only(f"modes {mode}")
            routes = _gnq_routes()
        cos, rel = _cosine(eps, base)
        # routing: every calibrated conv site runs int8 (per site or fused),
        # every ResBlock conv behind a GroupNorm takes the mode's prologue,
        # and every fused site its own statistics
        prologue = {"gn_prologue=fused": got["gn_silu_q"], "gn_prologue=stats": got["gn_stats"],
                    "conv=fused": got["qconv3_gn"]}[mode]
        routed = (got["qconv3"] + got["qconv3_gn"] == convs and got["nomax_fwd"] == attn
                  and got["int_mm"] == mms and got["flash_fwd"] == 0
                  and (prologue == gn_convs == len(sites) if mode != "conv=fused"
                       else 0 < prologue == got["gn_stats"] and got["gn_silu_q"] == 0)
                  and routes == want_routes[mode])
        log(f"modes {mode}: eps [2, 4, 64, 64] against the default mode: cosine {cos:.6f} "
            f"rel_l2 {rel:.5f} (limits cos >= {INT8_MIN_COS}, rel_l2 <= {INT8_MAX_REL_L2}); "
            f"launches {got} (int8 conv sites {convs}, of them behind a GroupNorm {gn_convs}, "
            f"no-max {attn}, int_mm {mms}; routed {routed}); int8 GN launches by route "
            f"{routes} (expected {want_routes[mode]}) [{state.get('card')}]")
        results[mode] = dict(cosine=cos, rel_l2=rel, launches=got, gnq_by_route=routes,
                             routed=routed)
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        if not (math.isfinite(rel) and rel <= INT8_MAX_REL_L2 and cos >= INT8_MIN_COS):
            raise RuntimeError(f"modes {mode}: rel_l2 {rel}, cosine {cos} outside the limits")
        if not routed:
            raise RuntimeError(f"modes {mode}: launch counts {got} do not match the policy")
    _site_check(state, "qconv3_gn", calls, qconv3_gn, qconv3_gn_plain)
    fused_paths = _plan_paths(calls, "qconv3_gn")
    log(f"modes conv=fused: qconv3_gn by path {fused_paths} in one eps call")
    results["conv=fused"]["qconv3_gn_by_path"] = fused_paths
    del calls
    results["requests"] = reqs = _fused_request(state, system)
    for name, mode in (("gn_silu_q", "gn_prologue=fused"), ("gn_stats", "gn_prologue=stats")):
        if name in state["kernels"]:
            k = state["kernels"][name]
            req = reqs[f"{mode} once"]
            k["launches"] = req[name]
            k["launches_by_route"] = req["gnq_by_route"][name]
            k["path"] = f"modes: a {mode} t2i request (512^2, n = 2, DDIM-{STEPS}, CFG)"
            if name == "gn_stats":
                k["launches_conv_fused"] = reqs["conv=fused once"]["gn_stats"]
    if "qconv3" in state["kernels"]:
        state["kernels"]["qconv3"]["launches_gn_prologue"] = totals["qconv3_gn"]
    state["modes"] = results


def _fused_request(state, system):
    """t2i requests under the default int8 policy, gn_prologue "fused" and
    "stats", conv "fused" and the default again, each once, in this call:
    times recorded beside each other, not gated. The opt-in
    modes' int8 GN launches are asserted as derived from the program: a
    request's UNet calls (STEPS, batch 4: 2 images x CFG) each launch
    gn_silu_q ("fused") or gn_stats ("stats") once at every int8 ResBlock
    GroupNorm site (``_int8_sites``' GroupNorm-fed convs), on its plan's
    route, and under conv "fused" gn_stats once before every qconv3_gn."""
    import torch
    from vdtpu_torch.ops.quant import QuantPolicy
    from vdtpu_torch.serving.api import VDInference
    vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                      ddim_steps=STEPS, n_sample_image=2)
    prompt = "a red cat sitting on a wooden bench in the sun"
    sites = _gnq_sites(system, 4)
    fused_sites = _gnq_sites(system, 4, QuantPolicy().fused_min_pixels)
    if len(sites) != _int8_sites(system)[1]:
        raise RuntimeError(f"modes: {len(sites)} int8 GN sites, {_int8_sites(system)[1]} "
                           "GroupNorm-fed int8 convs")
    n, nf = len(sites) * STEPS, len(fused_sites) * STEPS
    none_q, none_st = _gnq_expected([], False), _gnq_expected([], True)
    want = {"default": (dict(gn_silu_q=0, gn_stats=0), none_q, none_st),
            "gn_prologue=fused": (dict(gn_silu_q=n, gn_stats=0),
                                  _gnq_expected(sites, False, STEPS), none_st),
            "gn_prologue=stats": (dict(gn_silu_q=0, gn_stats=n), none_q,
                                  _gnq_expected(sites, True, STEPS)),
            "conv=fused": (dict(gn_silu_q=0, gn_stats=nf, qconv3_gn=nf), none_q,
                           _gnq_expected(fused_sites, True, STEPS))}
    out = {}
    for mode, pol in (("default", system.quant_policy),
                      ("gn_prologue=fused", QuantPolicy(gn_prologue="fused")),
                      ("gn_prologue=stats", QuantPolicy(gn_prologue="stats")),
                      ("conv=fused", QuantPolicy(conv="fused")),
                      ("default again", system.quant_policy)):
        counts, want_q, want_st = want[mode.replace(" again", "")]
        with _policy(system, pol):
            for run in ONCE:
                torch.cuda.synchronize()
                _zero_counters()
                t = time.perf_counter()
                img = vdi.inference_t2i(prompt, seed=SEED)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                got = _read_counters()
                routes = _gnq_routes()
                finite = bool(torch.isfinite(img).all())
                counted = ({k: got[k] for k in counts} == counts
                           and routes == {"gn_silu_q": want_q, "gn_stats": want_st})
                log(f"modes request {mode} {run}: {dt:.3f} s, finite {finite}, int8 conv "
                    f"{got['qconv3']} (fused prologue {got['qconv3_gn']}), gn_silu_q "
                    f"{got['gn_silu_q']}, gn_stats {got['gn_stats']}, int8 GN by route {routes} "
                    f"(expected {counts}) [{state.get('card')}]")
                if not finite:
                    raise RuntimeError(f"modes request {mode} {run}: non-finite output")
                if not counted:
                    raise RuntimeError(f"modes request {mode} {run}: launches {got} {routes}, "
                                       f"expected {counts} {want_q} {want_st}")
                out[f"{mode} {run}"] = dict(seconds=dt, qconv3=got["qconv3"],
                                            qconv3_gn=got["qconv3_gn"],
                                            gn_silu_q=got["gn_silu_q"], gn_stats=got["gn_stats"],
                                            gnq_by_route=routes)
    return out


def phase_eps_int8(state):
    """The card's int8 eps and the CPU copy with the same scales; the CPU
    call itself (tens of seconds of host work at full width) runs during
    ``main_parallel``, whose own process mostly waits on its ranks, where
    that phase runs too (``_eps_int8_cpu``), else here."""
    import torch
    from vdtpu_torch.ops.quant import load_quant_state, quant_state, set_quant_policy
    system = state.get("system")
    if system is None or system.quant_policy is None:
        raise RuntimeError("eps_int8 needs the calibrated system of main_int8")
    x, t, ctx = _eps_inputs(system, 1)
    eps_gpu, effect = _int8_eps(system, x, t, ctx)
    t0 = time.perf_counter()
    cpu_model = _cpu_model(system)
    set_quant_policy(cpu_model.diffuser, system.quant_policy)
    load_quant_state(cpu_model.diffuser,
                     {k: v.cpu() for k, v in quant_state(system.model.diffuser).items()})
    job = dict(eps_gpu=eps_gpu.cpu(), effect=effect, model=cpu_model,
               inputs=(x.float().cpu(), t.cpu(), ctx.float().cpu()),
               build_s=time.perf_counter() - t0)
    if "main_parallel" in state.get("phases", ()):
        state["eps_int8_job"] = job
        log(f"eps_int8: card eps done, CPU copy built in {job['build_s']:.1f} s; its call runs "
            f"during main_parallel")
    else:
        _eps_int8_cpu(state, job)


def _eps_int8_cpu(state, job, threads: int | None = None):
    """eps_int8's CPU call (in ``threads`` intra-op threads where given)
    and its gate."""
    import torch
    t0 = time.perf_counter()
    prev = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with torch.no_grad():
            eps_cpu = job.pop("model").apply_model(*job["inputs"], "image", "text")
    finally:
        torch.set_num_threads(prev)
    dt = time.perf_counter() - t0
    cos, rel = _cosine(job["eps_gpu"], eps_cpu)
    log(f"eps_int8: card bf16 int8 vs cpu f32 int8 (same scales) at [1, 4, 64, 64]: cosine "
        f"{cos:.6f} rel_l2 {rel:.5f} (limits cos >= {INT8_MIN_COS}, rel_l2 <= "
        f"{INT8_MAX_REL_L2}; int8's own error on the card, against the exact bf16 eps: rel_l2 "
        f"{job['effect']:.5f}); cpu copy built in {job['build_s']:.1f} s, its call {dt:.1f} s"
        f"{f' in {threads} threads beside main_parallel' if threads else ''} "
        f"[{state.get('card')}]")
    state["eps_int8"] = dict(cosine=cos, rel_l2=rel, int8_rel_l2_to_exact=job["effect"],
                             cpu_s=dt)
    if not (math.isfinite(rel) and rel <= INT8_MAX_REL_L2 and cos >= INT8_MIN_COS):
        raise RuntimeError("eps_int8: card result disagrees with the f32 CPU result")


def _fused2_launches(system, c_type: str, with_decode: bool = True):
    """Launches of one 50-step request under conv="fused2", derived from
    the program: every fused2 ResBlock one whole-ResBlock kernel per UNet
    call, and its two convs and two GroupNorms nothing else; every other
    calibrated conv site the int8 conv kernel; every QDense of the
    ``c_type`` context blocks torch._int_mm; the long self-attentions the
    no-max kernel; the remaining GroupNorms and the VAE decoder's the GN
    kernel."""
    n_f2 = len(_fused2_sites(system))
    convs, _, mms = _int8_sites(system, c_type)
    unet_gn, dec_gn, _ = _gn_sites(system, c_type)
    return {"resblock_q": n_f2 * STEPS, "qconv3": (convs - 2 * n_f2) * STEPS,
            "qconv3_gn": 0, "gn_stats": 0, "gn_silu_q": 0, "flash_fwd": 0,
            "nomax_fwd": 10 * STEPS, "int_mm": mms * STEPS,
            "gn_silu": (unet_gn - 2 * n_f2) * STEPS + (dec_gn if with_decode else 0)}


def phase_main_fused2(state):
    import torch
    from vdtpu_torch.ops.qconv import resblock_plain, resblock_plan, resblock_q, sm_count
    from vdtpu_torch.ops.quant import QuantPolicy
    from vdtpu_torch.serving.api import VDInference
    system = _system(state)
    calib_s = _calibrate(state, system, "main_fused2")
    sites = _fused2_sites(system)
    # launches by resblock_plan route of a request (UNet batch 4: 2 images x CFG)
    expect_paths = {"halo": 0, "general": 0}
    for c, n, side in sites:
        expect_paths[resblock_plan(4, side, side, c, n, sms=sm_count(0)).route] += STEPS
    log(f"main_fused2: {len(sites)} fused2 ResBlocks per UNet call (C_in, C_out, side): "
        f"{sites}")
    results = {"calibration_s": calib_s, "sites": sites}
    pol = QuantPolicy(conv="fused2")
    with _policy(system, pol):
        # the kernel against its plain version at every distinct fused2 site
        # of one CFG UNet call (batch 4), on the site's own arguments
        calls = []
        xs, ts, cs = _eps_inputs(system, 4)
        with torch.no_grad(), _recording("resblock_q", calls):
            system.model.apply_model(xs, ts, cs, "image", "text")
        seen, rows = set(), []
        for args, kwargs in calls:
            sig = (tuple(args[0].shape), args[3].shape[0], args[14] is not None)
            if sig in seen:
                continue
            seen.add(sig)
            err, rel, outside, ok = compare_resblock(resblock_q(*args, **kwargs),
                                                     resblock_plain(*args, **kwargs))
            torch.cuda.synchronize()
            rows.append(dict(site=list(sig), max_abs_err=err, rel_l2_err=rel,
                             outside_share=outside, ok=ok))
        del calls
        bad = [r["site"] for r in rows if not r["ok"]]
        log(f"  site check resblock_q: {len(rows)} distinct sites, max_abs_err "
            f"{max(r['max_abs_err'] for r in rows):.3e}, max rel_l2 "
            f"{max(r['rel_l2_err'] for r in rows):.3e}, max share outside two ulps "
            f"{max(r['outside_share'] for r in rows):.2e} (limits {RB_MAX_OUTSIDE}, "
            f"{RB_MAX_REL_L2}), disagreeing {bad} [{state.get('card')}]")
        if len(rows) != len(set((c, n) for c, n, _ in sites)) or bad:
            raise RuntimeError(f"main_fused2: site check {rows}")
        results["site_check"] = rows
        if "resblock_q" in state["kernels"]:
            k = state["kernels"]["resblock_q"]
            k["site_checks"] = rows
            k["max_abs_err"] = max(k["max_abs_err"], *(r["max_abs_err"] for r in rows))
        # one full-width eps call against conv="fused" (the same function)
        x, t, ctx = _eps_inputs(system, 2)
        with torch.no_grad():
            eps = system.model.apply_model(x, t, ctx, "image", "text").float()
            with _policy(system, QuantPolicy(conv="fused")):
                ref = system.model.apply_model(x, t, ctx, "image", "text").float()
        cos, rel = _cosine(eps, ref)
        log(f"main_fused2: eps [2, 4, 64, 64] against conv=\"fused\": cosine {cos:.6f} rel_l2 "
            f"{rel:.5f} (limits cos >= {INT8_MIN_COS}, rel_l2 <= {INT8_MAX_REL_L2}) "
            f"[{state.get('card')}]")
        results["eps_vs_fused"] = dict(cosine=cos, rel_l2=rel)
        if not (math.isfinite(rel) and rel <= INT8_MAX_REL_L2 and cos >= INT8_MIN_COS):
            raise RuntimeError("main_fused2: eps disagrees with conv=fused")
        vdi = VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                          ddim_steps=STEPS, n_sample_image=2)
        image = _i2i_image(SEED + 5)
        prompt = "a red cat sitting on a wooden bench in the sun"
        requests = (("t2i", "text", lambda: vdi.inference_t2i(prompt, seed=SEED)),
                    ("i2i_a", "image", lambda: vdi.inference_i2i(image, 0.0, 0.5, None,
                                                                  seed=SEED)))
        for label, c_type, run_request in requests:
            expect = _fused2_launches(system, c_type)
            for run in ONCE:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counters()
                t0 = time.perf_counter()
                img = run_request()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = _read_counters()
                attn_paths = _wgmma_only(f"main_fused2 {label} {run}")
                counts = {k: got[k] for k in expect}
                rb_paths = dict(resblock_q.launches_by_path)
                peak = torch.cuda.max_memory_allocated() / 2**30
                finite = bool(torch.isfinite(img).all())
                lo, hi = float(img.min()), float(img.max())
                log(f"main_fused2 {label} {run}: {dt:.3f} s, {2 / dt:.3f} images/s, peak "
                    f"{peak:.2f} GiB, shape {tuple(img.shape)} finite {finite} range "
                    f"[{lo:.4f}, {hi:.4f}], launches {counts} (expected {expect}), resblock_q "
                    f"by route {rb_paths} (expected {expect_paths}), attention by path "
                    f"{attn_paths} [{state.get('card')}]")
                if not (finite and tuple(img.shape) == (2, 512, 512, 3) and lo >= 0.0
                        and hi <= 1.0):
                    raise RuntimeError(f"main_fused2 {label} {run}: bad output")
                if counts != expect or rb_paths != expect_paths:
                    raise RuntimeError(f"main_fused2 {label} {run}: launch counts {counts} "
                                       f"!= {expect} or resblock_q routes {rb_paths} != "
                                       f"{expect_paths}")
                results[f"{label}_{run}"] = dict(seconds=dt, images_per_s=2 / dt,
                                                 peak_gib=peak, launches=counts,
                                                 resblock_q_by_route=rb_paths)
    if "resblock_q" in state["kernels"]:
        k = state["kernels"]["resblock_q"]
        k["launches"] = results["t2i_once"]["launches"]["resblock_q"]
        k["launches_by_path"] = results["t2i_once"]["resblock_q_by_route"]
        k["launches_i2i_a"] = results["i2i_a_once"]["launches"]["resblock_q"]
        k["path"] = "main_fused2 (int8 conv=\"fused2\", t2i request)"
    state["main_fused2"] = results


def _queue_vdi(system, steps: int, **kw):
    from vdtpu_torch.serving.api import VDInference
    return VDInference(system, text_tokenizer=stand_in_tokenizer, output_dim=(512, 512),
                       ddim_steps=steps, **kw)


def _bucket_sizes(vdi, sizes: list):
    """A copy of ``vdi`` whose samplers record the batch of each dispatch."""
    probe = copy.copy(vdi)

    def sample(gen, shape, x_info, c_info):
        sizes.append(shape[0])
        return vdi._sample(gen, shape, x_info, c_info)

    def sample_multi(gen, shape, x_info, c_info_list):
        sizes.append(shape[0])
        return vdi._sample_multi(gen, shape, x_info, c_info_list)

    probe._sample, probe._sample_multi = sample, sample_multi
    return probe


def _queue_run(vdi, requests, buckets=QUEUE_BUCKETS, sizes=None):
    """Submit ``requests`` ((prompt, seed) t2i pairs) together; every
    future's result, in order, and the sampler's batch of each dispatch."""
    from vdtpu_torch.serving.queue import BatchingQueue
    sizes = [] if sizes is None else sizes
    with BatchingQueue(_bucket_sizes(vdi, sizes), buckets=buckets, max_wait_ms=1000.0) as q:
        futs = [q.submit(text, seed) for text, seed in requests]
        out = [f.result() for f in futs]   # a failed group raises here
    return out, sizes


def _image_ok(img) -> bool:
    import torch
    return (tuple(img.shape) == (512, 512, 3) and bool(torch.isfinite(img).all())
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)


def _queue_full_bucket(state, system):
    """(a) 8 concurrent exact t2i requests, one bucket of 8 (the UNet at
    batch 16), DDIM-50, once; launches, GN routes at batch 16, peak
    memory; one profiled batch-16 CFG step. Returns (results, the
    bucket's images)."""
    import torch
    from vdtpu_torch.ops.flash import flash_attention
    from vdtpu_torch.ops.gn_silu import gn_silu
    vdi = _queue_vdi(system, STEPS)
    requests = [(p, SEED + i) for i, p in enumerate(QUEUE_PROMPTS)]
    unet_gn, vae_gn, _ = _gn_sites(system)
    expect = {"flash_fwd": 10 * STEPS, "gn_silu": unet_gn * STEPS + vae_gn}
    _, expect_routes = _mode_expect(system, [("text", 77)], [(True, 16)] * STEPS,
                                    _vae_routes(system, False, batch=8))
    results = {}
    for run in ONCE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t = time.perf_counter()
        imgs, sizes = _queue_run(vdi, requests)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"flash_fwd": flash_attention.launches, "gn_silu": gn_silu.launches}
        paths = _wgmma_only(f"main_queue (a) {run}")
        routes = _gn_routes(f"main_queue (a) {run}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"main_queue (a) bucket of 8 t2i {run}: {dt:.3f} s a batch, {dt / 8:.4f} s an "
            f"image, {8 / dt:.3f} images/s, sampler batches {sizes} (UNet batch "
            f"{2 * sizes[0]}), peak {peak:.2f} GiB, launches {counts} (expected {expect}), "
            f"attention by path {paths}, GN by route {routes} (expected {expect_routes}) "
            f"[{state.get('card')}]")
        if sizes != [8] or not all(_image_ok(im) for im in imgs):
            raise RuntimeError(f"main_queue (a) {run}: batches {sizes} or a bad image")
        if counts != expect or routes != expect_routes:
            raise RuntimeError(f"main_queue (a) {run}: launches {counts} != {expect} or GN "
                               f"routes {routes} != {expect_routes}")
        results[run] = dict(seconds=dt, s_per_image=dt / 8, images_per_s=8 / dt,
                            peak_gib=peak, launches=counts, attention_by_path=paths,
                            gn_by_route=routes)
    ids = stand_in_tokenizer(["", QUEUE_PROMPTS[0]])
    prof = _profile_step(state, system, "main_queue (a)", system.ctx_encode(ids[:1], "text"),
                         system.ctx_encode(ids[1:], "text"), images=8)
    if prof is not None:
        _, _, busy, wall, _ = prof
        results["profiled_step"] = dict(batch=16, busy_ms=busy, wall_ms=1e3 * wall,
                                        idle_share=1 - busy / (1e3 * wall))
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            state["kernels"][name]["launches_queue_bucket8"] = results["once"]["launches"][name]
    return results, imgs


def _queue_riders(state, system, label: str, expect=None):
    """(b) the same request in two full buckets of 8, each with 7 other
    co-riders, QUEUE_STEPS steps: bit-equal.
    (c) the request at bucket 1 against inference_t2i at n = 1: bit-equal.
    ``expect``: the launch counts of the first bucket, where given."""
    import torch
    vdi = _queue_vdi(system, QUEUE_STEPS)
    req = (QUEUE_PROMPTS[0], SEED)
    riders_a = [(p, SEED + 10 + i) for i, p in enumerate(QUEUE_PROMPTS[1:])]
    riders_b = [(QUEUE_PROMPTS[0], SEED + 30)] + [(p, SEED + 40 + i)
                                                  for i, p in enumerate(QUEUE_PROMPTS[2:])]
    _zero_counters()
    (a, *_), sizes_a = _queue_run(vdi, [req] + riders_a)
    torch.cuda.synchronize()
    got = _read_counters()
    (b, *_), sizes_b = _queue_run(vdi, [req] + riders_b)
    (solo,), sizes_1 = _queue_run(vdi, [req], buckets=(1,))
    direct = _queue_vdi(system, QUEUE_STEPS, n_sample_image=1).inference_t2i(*req)
    co, one = bool(torch.equal(a, b)), bool(torch.equal(solo, direct[0]))
    counts = {k: got[k] for k in expect} if expect else {}
    log(f"main_queue (b) {label}: co-riders bit-equal {co} (batches {sizes_a}, {sizes_b}), "
        f"max |diff| {float((a.float() - b.float()).abs().max()):.3e}; (c) bucket 1 (batches "
        f"{sizes_1}) against inference_t2i at n = 1 bit-equal {one}; launches of the first "
        f"bucket {counts} (expected {expect}) [{state.get('card')}]")
    if not (co and one and sizes_a == sizes_b == [8] and sizes_1 == [1] and _image_ok(a)):
        raise RuntimeError(f"main_queue (b)/(c) {label}: co-riders {co}, bucket 1 {one}, "
                           f"batches {sizes_a} {sizes_b} {sizes_1}")
    if expect and counts != expect:
        raise RuntimeError(f"main_queue (b) {label}: launches {counts} != {expect}")
    return dict(co_riders_bit_equal=co, bucket1_equals_direct=one, launches=counts)


def _queue_flows(state, system):
    """(e) one request of each of the seven flows submitted together,
    QUEUE_STEPS steps: each is its own group at bucket 1 and must equal its
    flow's direct call at n = 1 (images bit for bit, texts equal)."""
    import torch
    from vdtpu_torch.serving.queue import BatchingQueue
    dim = dict(system.cfg["args"]["diffuser_cfg_list"])["text"]["args"]["input_channels"]
    vdi = _queue_vdi(system, QUEUE_STEPS, n_sample_image=1, n_sample_text=1,
                     text_latent_dim=dim)
    images, mask = _mcg_inputs()
    image = _i2i_image(SEED + 5, 480, 640)   # regularized to 512^2 on the way in
    tcg = [{"image": images[0], "fcs_lvl": 0.5}, {"image": images[1], "mask": mask}]
    mcg = [{"image": im} for im in images]
    flows = {
        "t2i": (lambda q: q.submit(TEXT_PROMPT, SEED + 1),
                lambda: vdi.inference_t2i(TEXT_PROMPT, SEED + 1)[0]),
        "i2i": (lambda q: q.submit_i2i(image, 0.5, 0.3, "Simple", SEED + 2),
                lambda: vdi.inference_i2i(image, 0.5, 0.3, "Simple", SEED + 2)[0]),
        "i2t": (lambda q: q.submit_i2t(image, SEED + 3),
                lambda: vdi.inference_i2t(image, SEED + 3)[0]),
        "t2t": (lambda q: q.submit_t2t(TEXT_PROMPT, SEED + 4),
                lambda: vdi.inference_t2t(TEXT_PROMPT, SEED + 4)[0]),
        "dcg": (lambda q: q.submit_dcg(images[2], 0.5, TEXT_PROMPT, 0.5, SEED + 5),
                lambda: vdi.inference_dcg(images[2], 0.5, TEXT_PROMPT, 0.5, SEED + 5)[0]),
        "tcg": (lambda q: q.submit_tcg(tcg, TEXT_PROMPT, 0.3, SEED + 6),
                lambda: vdi.inference_tcg(tcg, TEXT_PROMPT, 0.3, SEED + 6)[1][0]),
        "mcg": (lambda q: q.submit_mcg(mcg, None, 0.5, SEED + 7),
                lambda: vdi.inference_mcg(mcg, None, 0.5, SEED + 7)[1][0]),
    }
    sizes = []
    t = time.perf_counter()
    with BatchingQueue(_bucket_sizes(vdi, sizes), buckets=QUEUE_BUCKETS,
                       max_wait_ms=1000.0) as q:
        futs = {k: submit(q) for k, (submit, _) in flows.items()}
        queued = {k: f.result() for k, f in futs.items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    results, bad = {}, []
    for k, (_, direct) in flows.items():
        ref, out = direct(), queued[k]
        if isinstance(ref, str):
            ok = isinstance(out, str) and out == ref
        else:
            ok = bool(torch.equal(out, ref)) and _image_ok(out)
        results[k] = ok
        if not ok:
            bad.append(k)
    log(f"main_queue (e) seven flows in one sweep, {QUEUE_STEPS} steps: {dt:.3f} s, sampler "
        f"batches {sorted(sizes)}, equal to the direct call at n = 1: {results}; texts "
        f"{queued['i2t'][:60]!r} / {queued['t2t'][:60]!r} [{state.get('card')}]")
    if bad or sorted(sizes) != [1] * 7:
        raise RuntimeError(f"main_queue (e): flows {bad} differ from their direct calls or "
                           f"batches {sizes} are not seven of 1")
    return dict(seconds=dt, equal=results)


def _synthetic_clip_vocab(vocab_path: str, merges_path: str):
    """A CLIP BPE vocabulary of the 256 byte characters, their </w> forms and
    the two specials (no merges): every id inside the text tower's 49408."""
    from vdtpu_torch.data.tokenizers import bytes_to_unicode
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    with open(merges_path, "w") as f:
        f.write("#version: synthetic\n")


def _queue_cli(state):
    """(f) the CLI at full width on the card: t2i writes two 512^2 PNGs (read
    back by the CLI's own reader), t2t prints its texts."""
    import io
    import tempfile
    import torch
    from vdtpu_torch.serving import cli
    with tempfile.TemporaryDirectory() as tmp:
        vocab, merges = os.path.join(tmp, "vocab.json"), os.path.join(tmp, "merges.txt")
        _synthetic_clip_vocab(vocab, merges)
        common = ["--bf16", "--steps", str(CLI_STEPS), "--clip-vocab", vocab,
                  "--clip-merges", merges, "--out", os.path.join(tmp, "out"), "--seed",
                  str(SEED)]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli.main(["t2i", "--text", TEXT_PROMPT] + common)
        t2i_s = time.perf_counter() - t
        pngs = sorted(f for f in os.listdir(os.path.join(tmp, "out")) if f.endswith(".png"))
        arrays = [cli.read_png(os.path.join(tmp, "out", f)) for f in pngs]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text_out:
            cli.main(["t2t", "--text", TEXT_PROMPT, "--n-texts", "2"] + common)
        t2t_s = time.perf_counter() - t
    texts = text_out.getvalue().rstrip("\n").split("\n")
    torch.cuda.empty_cache()
    ok = (pngs == ["t2i_0.png", "t2i_1.png"] and "t2i_0.png" in out.getvalue()
          and all(a.shape == (512, 512, 3) and a.dtype.name == "uint8" for a in arrays)
          and len(texts) == 2)
    log(f"main_queue (f) CLI: t2i {t2i_s:.2f} s (system built, {CLI_STEPS} steps), PNGs "
        f"{pngs} {[a.shape for a in arrays]} read back, pixel mean "
        f"{[round(float(a.mean()), 2) for a in arrays]}; t2t {t2t_s:.2f} s, texts "
        f"{[t[:40] for t in texts]} [{state.get('card')}]")
    if not ok:
        raise RuntimeError(f"main_queue (f): CLI output {pngs}, {len(texts)} texts")
    return dict(t2i_s=t2i_s, t2t_s=t2t_s, pngs=pngs, texts=len(texts))


def _tome_merge_scatter_add(x, ratio: float):
    """The merge closure as the port built it before its one-hot product:
    the sources added into their destinations by scatter_add_, whose atomic
    adds land in any order (the yardstick of the merge's time)."""
    import torch
    from vdtpu_torch.ops.tome import _partition, merge_count
    b, n, _ = x.shape
    r = merge_count(n, ratio)
    dst_np, src_np = _partition(n)
    dst_idx, src_idx = (torch.from_numpy(a).to(x.device) for a in (dst_np, src_np))
    xm = x.float()
    xm = xm / (torch.linalg.vector_norm(xm, dim=-1, keepdim=True) + 1e-6)
    best_val, best_dst = torch.einsum("bsc,bdc->bsd", xm[:, src_idx], xm[:, dst_idx]).max(-1)
    order = torch.argsort(-best_val, dim=-1, stable=True)
    merged_pos, kept_pos = order[:, :r], order[:, r:]
    dst_of = torch.gather(best_dst, 1, merged_pos)
    counts = torch.zeros((b, len(dst_np)), device=x.device)
    counts.scatter_add_(1, dst_of, torch.ones_like(dst_of, dtype=torch.float32))
    rows = lambda t, idx: torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    def merge(h):
        hsrc, hdst = h[:, src_idx], h[:, dst_idx]
        add = torch.zeros(hdst.shape, dtype=torch.float32, device=h.device)
        add.scatter_add_(1, dst_of[..., None].expand(-1, -1, h.shape[-1]),
                         rows(hsrc, merged_pos).float())
        hdst = ((hdst.float() + add) / (1.0 + counts[..., None])).to(h.dtype)
        return torch.cat([rows(hsrc, kept_pos), hdst], dim=1)

    return merge


def _queue_tome_merge(state):
    """ToMe's merge at TOME_SHAPES, ratio TOME_RATIO: the port's one-hot
    merge (deterministic: TOME_RUNS more merges bit-equal to the first,
    required) against the scatter_add_ merge it replaced (its runs that
    differ counted); device ms of the merge closure (graph replay) and
    eager ms of the assignment plus the merge."""
    import torch
    from vdtpu_torch.ops.tome import ToMeSpec, build_merge
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    spec, out = ToMeSpec(TOME_RATIO), {}
    for shape in TOME_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        merge, old = build_merge(x, spec)[0], _tome_merge_scatter_add(x, TOME_RATIO)
        a, o1 = merge(x), old(x)
        # runs of each that differ in any bit from its first
        differ = sum(not torch.equal(merge(x), a) for _ in range(TOME_RUNS))
        old_differ = sum(not torch.equal(old(x), o1) for _ in range(TOME_RUNS))
        err, same = float((a.float() - o1.float()).abs().max()), differ == 0
        r = dict(deterministic=same, runs=TOME_RUNS, scatter_add_runs_differing=old_differ,
                 max_abs_vs_scatter_add=err, ms=time_graph_ms(lambda: merge(x)),
                 scatter_add_ms=time_graph_ms(lambda: old(x)),
                 eager_build_and_merge_ms=time_ms(lambda: build_merge(x, spec)[0](x), 10),
                 eager_scatter_add_build_and_merge_ms=time_ms(
                     lambda: _tome_merge_scatter_add(x, TOME_RATIO)(x), 10))
        log(f"main_queue ToMe merge {list(shape)} ratio {TOME_RATIO}: one-hot {r['ms']:.4f} ms "
            f"(device, graph), scatter_add_ {r['scatter_add_ms']:.4f} ms; with the "
            f"assignment, eager {r['eager_build_and_merge_ms']:.4f} / "
            f"{r['eager_scatter_add_build_and_merge_ms']:.4f} ms; of {TOME_RUNS} more runs "
            f"{differ} one-hot and {old_differ} scatter_add_ merges differ from their first; "
            f"max |one-hot - scatter_add_| {err:.3e} [{state.get('card')}]")
        if not same:
            raise RuntimeError(f"main_queue: ToMe's merge at {shape} is not deterministic")
        out[str(list(shape))] = r
    return out


def phase_main_queue(state):
    """The serving queue at full width: (a) a bucket of 8, (d) bucket 1
    against bucket 8, (b) and (c) under exact, int8 and int8 + ToMe, (e)
    the seven flows, (f) the CLI; and ToMe's merge timed."""
    import torch
    from vdtpu_torch.ops.quant import QuantPolicy
    system = _system(state)
    results = {"tome_merge": _queue_tome_merge(state)}
    with _policy(system, None):
        results["a"], imgs = _queue_full_bucket(state, system)
        # (d) the bucket's first request alone at bucket 1, DDIM-50, and (c)
        # at 50 steps: the same request through inference_t2i at n = 1
        vdi = _queue_vdi(system, STEPS)
        (solo,), _ = _queue_run(vdi, [(QUEUE_PROMPTS[0], SEED)], buckets=(1,))
        direct = _queue_vdi(system, STEPS, n_sample_image=1).inference_t2i(QUEUE_PROMPTS[0],
                                                                           SEED)
        cos, rel = _cosine(solo, imgs[0])
        one = bool(torch.equal(solo, direct[0]))
        log(f"main_queue (d) bucket 1 against bucket 8, DDIM-50: relative L2 {rel:.5f}, "
            f"cosine {cos:.6f}, bit-equal {bool(torch.equal(solo, imgs[0]))} (gate: relative "
            f"L2 <= {QUEUE_MAX_REL_L2}, cosine >= {QUEUE_MIN_COS}); (c) exact, DDIM-50: "
            f"bucket 1 against inference_t2i at n = 1 bit-equal {one} [{state.get('card')}]")
        if not (rel <= QUEUE_MAX_REL_L2 and cos >= QUEUE_MIN_COS and one):
            raise RuntimeError(f"main_queue (d)/(c): relative L2 {rel}, cosine {cos}, "
                               f"bucket 1 = direct {one}")
        results["d"] = dict(rel_l2=rel, cosine=cos, bucket1_equals_direct_50=one)
        results["b_exact"] = _queue_riders(state, system, "exact")
    calib_s = _calibrate(state, system, "main_queue")
    with _policy(system, QuantPolicy()):
        try:
            for label, ratio in (("int8", None), ("int8_tome", TOME_RATIO)):
                system.enable_tome(ratio or 0)
                expect, _ = _int8_launches(system, ratio, steps=QUEUE_STEPS)
                results[f"b_{label}"] = _queue_riders(state, system, label, expect)
        finally:
            system.enable_tome(0)
    with _policy(system, None):
        results["e"] = _queue_flows(state, system)
    results["f"] = _queue_cli(state)
    results["calibration_s"] = calib_s
    for name in ("nomax_fwd", "qconv3"):
        if name in state["kernels"]:
            state["kernels"][name]["launches_queue_int8_bucket8"] = \
                results["b_int8"]["launches"][name]
    state["main_queue"] = results


# ---- main_quality: the VAE loss, the eval stage, the serving-policy gate ----

def _vae_loss_pass(vae, loss, x, backward: bool):
    """One reconstruction pass (posterior mode) and both loss branches: the
    generator loss with the adaptive weight (and its backward when asked),
    then the discriminator loss. Returns (every logged term as a float, the
    running statistics before, after the generator branch, after the
    discriminator branch)."""
    import torch
    snap = lambda: {k: v.clone() for k, v in loss.discriminator.state_dict().items()
                    if "running" in k}
    before = snap()
    rec, post = vae(x)
    xi, ri = x * 2.0 - 1.0, rec * 2.0 - 1.0
    # the adaptive weight's ratio before its clip at 1e4 (random weights
    # put it above), so the comparison reads the gradients themselves
    w = vae.decoder.conv_out.weight
    nll, _ = loss.nll_and_rec(xi, ri)
    grads = [torch.autograd.grad(v, w, retain_graph=True)[0].norm()
             for v in (nll, -torch.mean(loss.discriminator(ri)))]
    g, glog = loss.generator_loss(xi, ri, post, loss.disc_start,
                                  last_layer=vae.decoder.conv_out.weight)
    if backward:
        g.backward()
    after_g = snap()
    d, dlog, _ = loss.discriminator_loss(xi, ri, loss.disc_start)
    terms = {f"g.{k}": float(torch.as_tensor(v).detach()) for k, v in glog.items()}
    terms["g.d_weight_unclipped"] = float(grads[0] / (grads[1] + 1e-4))
    terms.update({f"d.{k}": float(torch.as_tensor(v).detach()) for k, v in dlog.items()})
    return terms, before, after_g, snap()


def _quality_vae_loss(state):
    """(a) KL-f8's reconstruction pass at its training resolution, batch
    QUALITY_LOSS_BATCH, f32 with grad, through LPIPS + PatchGAN on the card;
    every term and d_weight against the same modules and weights in f32 on
    the CPU (TF32 off); the running statistics move only in the
    discriminator branch; GN launches = the GroupNorms of one encoder and
    one decoder pass (the backward recomputes the plain version); the GN
    kernel against its plain version at every distinct f32 site of the
    card's pass, on that site's own arguments."""
    import torch
    from vdtpu_torch.config.configs import model_cfg_bank
    from vdtpu_torch.config.registry import build
    from vdtpu_torch.models.autokl_loss import LPIPSWithDiscriminator
    from vdtpu_torch.models.layers import GroupNorm32, init_random
    from vdtpu_torch.ops.gn_silu import gn_silu
    cfg = dict(model_cfg_bank()("vd_four_flow_v1-0")["args"]["vae_cfg_list"])["image"]
    size = cfg["args"]["ddconfig"]["resolution"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    with torch.device("cuda"):
        vae = build(cfg)
        loss = LPIPSWithDiscriminator(disc_start=50001, kl_weight=1e-6, disc_weight=0.5)
    init_random(vae, gen)
    for m in loss.modules():
        if isinstance(m, torch.nn.Conv2d):
            init_random(m, gen)
    x = torch.rand((QUALITY_LOSS_BATCH, 3, size, size), generator=gen, device="cuda")
    # f32 CPU twins taken before the card's pass updates the statistics; only
    # the last kernel needs a gradient there (the adaptive weight)
    cpu_vae, cpu_loss = (copy.deepcopy(m).cpu().requires_grad_(False) for m in (vae, loss))
    cpu_vae.decoder.conv_out.weight.requires_grad_(True)
    expect_gn = sum(isinstance(m, GroupNorm32) for part in (vae.encoder, vae.decoder)
                    for m in part.modules())
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gn_calls = []
    try:
        torch.cuda.synchronize()
        _zero_counters()
        t = time.perf_counter()
        with _recording_gn(gn_calls):
            terms, before, after_g, after_d = _vae_loss_pass(vae, loss, x, backward=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got, routes = _read_counters(), dict(gn_silu.launches_by_path)
        grads_ok = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                       for p in vae.parameters())
        t = time.perf_counter()
        ref, *_ = _vae_loss_pass(cpu_vae, cpu_loss, x.cpu(), backward=False)
        dt_cpu = time.perf_counter() - t
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rel = {k: abs(terms[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref}
    bound = {k: QUALITY_GRAD_RTOL if k == "g.d_weight_unclipped" else QUALITY_LOSS_RTOL
             for k in ref}
    worst = max(rel, key=lambda k: rel[k] / bound[k])
    worst_term = max((k for k in rel if k != "g.d_weight_unclipped"), key=rel.get)
    moved_g = any(not torch.equal(before[k], after_g[k]) for k in before)
    moved_d = all(not torch.equal(after_g[k], after_d[k]) for k in before)
    log(f"main_quality (a) VAE loss at {size}^2, batch {QUALITY_LOSS_BATCH}, f32, TF32 off: "
        f"{dt:.3f} s on the card with the backward, {dt_cpu:.3f} s on the CPU without; "
        f"terms {json.dumps({k: round(v, 6) for k, v in terms.items()})}; largest relative "
        f"difference to the CPU, against its bound, {rel[worst]:.3e} ({worst}; bound "
        f"{bound[worst]}); largest on a loss term {rel[worst_term]:.3e} ({worst_term}; "
        f"bound {QUALITY_LOSS_RTOL}); unclipped d_weight {rel['g.d_weight_unclipped']:.3e} "
        f"(bound {QUALITY_GRAD_RTOL}); "
        f"running statistics moved by the generator branch {moved_g}, by the discriminator "
        f"branch {moved_d}; GN launches {got['gn_silu']} (expected {expect_gn}, by route "
        f"{routes}); VAE gradients finite {grads_ok} [{state.get('card')}]")
    if not all(math.isfinite(v) for v in terms.values()) or rel[worst] > bound[worst]:
        raise RuntimeError(f"main_quality (a): card against CPU {rel}")
    if moved_g or not moved_d or not grads_ok:
        raise RuntimeError(f"main_quality (a): statistics moved by the generator branch "
                           f"{moved_g}, by the discriminator branch {moved_d}; gradients "
                           f"finite {grads_ok}")
    if got != {k: (expect_gn if k == "gn_silu" else 0) for k in got}:
        raise RuntimeError(f"main_quality (a): launches {got}, expected {expect_gn} GN")
    if len(gn_calls) != expect_gn:
        raise RuntimeError(f"main_quality (a): {len(gn_calls)} GN calls recorded, expected "
                           f"{expect_gn}")
    gn_rows = _gn_site_check(state, "main_quality", gn_calls)
    del vae, loss, cpu_vae, cpu_loss, x, gn_calls
    torch.cuda.empty_cache()
    return dict(seconds=dt, cpu_seconds=dt_cpu, terms=terms, cpu_terms=ref, rel_diff=rel,
                gn_launches=got["gn_silu"], gn_by_route=routes, gn_site_check=gn_rows)


def _counted(state, label: str, fn, expect):
    """``fn`` wrapped: counters zeroed before each call and read after it,
    against ``expect`` (every other counter 0); returns (wrapper, records)."""
    import torch
    records = []

    def run(*args):
        torch.cuda.synchronize()
        _zero_counters()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        got = _read_counters()
        records.append(dict(seconds=time.perf_counter() - t, launches=got))
        if got != {k: expect.get(k, 0) for k in got}:
            raise RuntimeError(f"{label} call {len(records)}: launches {got} != {expect}")
        return out
    return run, records


def _quality_eval(state):
    """(b) The eval stage on the serving system, exact bf16: two batches of
    2 captions at DDIM-50 scored with CLIP-sim through EvalStage, then one
    batch at DPM-Solver++ 20 scored with CLIP-FID against seeded reals; each
    batch's flash and GN launches as derived for a 2-image request."""
    import numpy as np
    import torch
    from vdtpu_torch.training.evaluator import EvalStage
    from vdtpu_torch.training.launch import build_eval
    system = _system(state)
    rs = np.random.RandomState(SEED + 13)
    batches = [{"caption": list(QUEUE_PROMPTS[i:i + 2]),
                "image": rs.rand(2, 512, 512, 3).astype(np.float32)} for i in (0, 2, 4)]
    text = [("text", 77)]
    results = {}
    with _policy(system, None):
        vae = _vae_routes(system, False)
        runs = (("clip_similarity", dict(ddim_steps=STEPS), batches[:2],
                 [(True, 4)] * STEPS),
                ("fid", dict(ddim_steps=MODE_STEPS, sampler="dpmpp2m", evaluator="fid"),
                 batches[2:], [(True, 4)] * MODE_STEPS))
        for name, vcfg, data, plan in runs:
            flash, gn = _mode_expect(system, text, plan, vae)
            expect = {"flash_fwd": sum(flash.values()), "gn_silu": sum(gn.values())}
            sample_fn, evaluator = build_eval(system, stand_in_tokenizer,
                                              dict(vcfg, seed=SEED))
            counted, records = _counted(state, f"main_quality (b) {name}", sample_fn, expect)
            t = time.perf_counter()
            summary = EvalStage(evaluator, counted)(data)
            dt = time.perf_counter() - t
            value = summary[name]
            log(f"main_quality (b) eval {name} {vcfg}: {len(data)} batches of 2 in {dt:.3f} s "
                f"(sampling {[round(r['seconds'], 3) for r in records]} s), summary {summary}, "
                f"launches a batch {records[0]['launches']} (expected {expect}) "
                f"[{state.get('card')}]")
            if not math.isfinite(value) or (name == "clip_similarity" and abs(value) > 1.0):
                raise RuntimeError(f"main_quality (b) {name}: summary {summary}")
            results[name] = dict(summary=summary, seconds=dt, batches=records, expected=expect)
    return results


def _quality_expect(system, name: str):
    """Launches and no-max launches by kv length of one gate variant
    (sample + decode at 2 images), derived as main_int8 / main_modes do."""
    if name.startswith("bf16_exact"):
        return _mc_launches(system, [("text", 77)])[0], {}
    if name.startswith("clip=") or name in ("int8", "int8+cfgitv(0.1,0.8)"):
        return _int8_launches(system, None)
    if name.startswith("int8+tome"):
        return _int8_launches(system, float(name[len("int8+tome"):]))
    if name == f"int8+dpmpp{MODE_STEPS}":
        return _int8_launches(system, None, steps=MODE_STEPS)
    reuse = {"int8+encreuse2": (STEPS, 2), "int8+encreuse3": (STEPS, 3),
             f"int8+dpmpp{MODE_STEPS}+encreuse2": (MODE_STEPS, 2)}
    steps, interval = reuse[name]
    expect, by_kv, _ = _int8_reuse_launches(system, None, None, steps, interval)
    return expect, by_kv


def _quality_gate(state):
    """(c) ``vdtpu_torch.quality.main`` in the random-fill and surrogate
    regimes, and its calibration sweep ("none" and QUALITY_SWEEP) in the
    surrogate one: each variant's launches as derived; every row finite, the
    exact row bit-equal across its two runs; each row's metrics and
    README's verdict (within 0.5 dB of the int8 row's PSNR and CLIP-sim
    |delta| <= 0.002, in both regimes), a finding, not a check."""
    import torch
    from vdtpu_torch import quality
    by_kv_now = _counters()["nomax_fwd"].launches_by_kv
    launches = {}

    def observe(label):
        def run(name, system, thunk):
            expect, expect_kv = _quality_expect(system, name)
            torch.cuda.synchronize()
            _zero_counters()
            t = time.perf_counter()
            out = thunk()
            torch.cuda.synchronize()
            got, by_kv = _read_counters(), dict(by_kv_now)
            launches[f"{label} {name}"] = dict(seconds=time.perf_counter() - t, launches=got,
                                               nomax_by_kv=by_kv)
            if got != {k: expect.get(k, 0) for k in got} or by_kv != expect_kv:
                raise RuntimeError(f"main_quality (c) {label} {name}: launches {got}, no-max "
                                   f"by kv {by_kv}; expected {expect}, {expect_kv}")
            return out
        return run

    runs = {}
    inner = quality.VDSystem    # the gate's systems at LAUNCH_LEVELS (module comment)
    quality.VDSystem = functools.partial(inner, model_args=_launch_model_args())
    try:
        for label, argv in (("random_fill", []), ("surrogate", ["--surrogate"]),
                            ("surrogate_sweep", ["--surrogate", "--clip-sweep", QUALITY_SWEEP])):
            t = time.perf_counter()
            runs[label] = quality.main(["--seed", str(SEED), *argv], observe=observe(label))
            mine = {k: v["launches"] for k, v in launches.items()
                    if k.startswith(label + " ")}
            log(f"main_quality (c) {label} (three levels): {time.perf_counter() - t:.1f} s, "
                f"launches {json.dumps(mine)} [{state.get('card')}]")
    finally:
        quality.VDSystem = inner
    bad = []
    for label in ("random_fill", "surrogate"):
        out = runs[label]
        if not out["bf16_exact_repeat_bit_equal"]:
            bad.append(f"{label}: the exact row differs between its two runs")
        for name, row in out.items():
            if isinstance(row, dict) and "decoded_psnr_db" in row:
                vals = [*row.values(), out["clip_sim"][name]]
                if not all(math.isfinite(v) for v in vals):
                    bad.append(f"{label} {name}: {row}")
    for mode, row in runs["surrogate_sweep"]["clip_sweep"].items():
        if not all(math.isfinite(v) for v in row.values()):
            bad.append(f"surrogate_sweep {mode}: {row}")
    if bad:
        raise RuntimeError(f"main_quality (c): {bad}")
    verdict = {}
    names = [k for k, v in runs["random_fill"].items() if isinstance(v, dict)
             and "decoded_psnr_db" in v]
    for name in names:
        per = {}
        for label in ("random_fill", "surrogate"):
            out = runs[label]
            row = out[name]
            d_psnr = row["decoded_psnr_db"] - out["int8"]["decoded_psnr_db"]
            d_clip = out["clip_sim_delta_vs_int8"][name]
            per[label] = dict(d_psnr_db=round(d_psnr, 2), d_clip_sim=d_clip,
                              within=bool(d_psnr >= -0.5 and abs(d_clip) <= 0.002))
            log(f"main_quality (c) {label} | {name} | cos {row['final_latent_cos']} | rel err "
                f"{row['final_latent_rel_err']} | MAE {row['decoded_mae']} | PSNR "
                f"{row['decoded_psnr_db']} dB | CLIP-sim {out['clip_sim'][name]} | delta vs "
                f"int8 {d_clip} | [{state.get('card')}]")
        verdict[name] = dict(per, admitted=all(p["within"] for p in per.values()))
    for label in ("random_fill", "surrogate"):
        log(f"main_quality (c) {label}: exact CLIP-sim {runs[label]['clip_sim']['bf16_exact']}, "
            f"int8 step cos min {runs[label]['int8_step_cos_min']:.6f}, exact row bit-equal "
            f"across two runs {runs[label]['bf16_exact_repeat_bit_equal']}")
    for mode, row in runs["surrogate_sweep"]["clip_sweep"].items():
        log(f"main_quality (c) surrogate clip sweep | {mode} | {json.dumps(row)}")
    log("main_quality (c) verdict (README's gate: PSNR within 0.5 dB of the int8 row and "
        "|CLIP-sim delta| <= 0.002 in both regimes): " + json.dumps(
            {k: v["admitted"] for k, v in verdict.items()}) + f" [{state.get('card')}]")
    return dict(runs=runs, verdict=verdict, launches=launches)


def phase_main_quality(state):
    import torch
    t = time.perf_counter()
    results = {"vae_loss": _quality_vae_loss(state), "eval": _quality_eval(state),
               "gate": _quality_gate(state)}
    torch.cuda.empty_cache()
    results["seconds"] = time.perf_counter() - t
    log(f"main_quality: {results['seconds']:.1f} s (limit about {QUALITY_SECONDS} s) "
        f"[{state.get('card')}]")
    for name in ("flash_fwd", "gn_silu"):
        if name in state["kernels"]:
            state["kernels"][name]["launches_quality_eval"] = \
                results["eval"]["clip_similarity"]["batches"][0]["launches"][name]
    for name in ("nomax_fwd", "qconv3"):
        if name in state["kernels"]:
            state["kernels"][name]["launches_quality_int8"] = \
                results["gate"]["launches"]["random_fill int8"]["launches"][name]
    state["main_quality"] = results


def phase_probes(state):
    """The probes' entry point, ``vdtpu_torch.probes.main()``: every probe
    exact against its plain version and the script's check (main raises
    otherwise), each kernel launched exactly LAUNCHES_PER_PROBE times."""
    from vdtpu_torch import probes
    from vdtpu_torch.ops.probes import probe_s8mm, probe_scratch, probe_shift
    counters = {"probe_s8mm": probe_s8mm, "probe_shift": probe_shift,
                "probe_scratch": probe_scratch}
    for fn in counters.values():
        fn.launches = 0
    results = probes.main()
    counts = {k: fn.launches for k, fn in counters.items()}
    expect = {k: probes.LAUNCHES_PER_PROBE for k in counters}
    log(f"probes: {[(r['probe'], r['ok']) for r in results]}, launches {counts} "
        f"(expected {expect}) [{state.get('card')}]")
    if counts != expect or not all(r["ok"] for r in results):
        raise RuntimeError(f"probes: launch counts {counts} != {expect} or a probe failed")
    for name, r in zip(counters, results):
        if name in state["kernels"]:
            k = state["kernels"][name]
            k["launches"] = counts[name]
            k["path"] = "probes (python -m vdtpu_torch.probes: check + timing)"
    state["probes"] = results


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
    _zero_counters(*_train_counters().values())
    loss, _ = loss_fn(x, ctx, t, noise)
    loss.backward()
    torch.cuda.synchronize()
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    return grads, loss.item(), {k: c.launches for k, c in _train_counters().items()}


def phase_train(state):
    """t2i training at full width through ``Trainer``, on pre-encoded batches
    (the harness's default contract): seeded normal latents and stand-in
    prompts, no data path (``main_launch`` drives the launcher, the shards,
    the VAE encoder and the latent cache)."""
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
    _wgmma_only("train gradient check")
    with _plain_kernels():
        g_plain, loss_p, counts_p = _train_grads(loss_fn, params, *args)
    cos, rel = _grad_agreement(g_kern, g_plain)
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
        _zero_counters(*_train_counters().values())
        t = time.perf_counter()
        trainer.run(batches, num_iters=i + 1, seed=SEED)
        loss = trainer.last_loss  # waits for the step
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {k: c.launches for k, c in _train_counters().items()}
        paths = _wgmma_only(f"train step {i + 1}")["flash_fwd"]
        gn_routes = _gn_routes(f"train step {i + 1}")
        steps.append(dict(seconds=dt, loss=loss, launches=counts, flash_fwd_by_path=paths,
                          gn_by_route=gn_routes))
        log(f"train step {i + 1}: {dt:.3f} s, {TRAIN_BATCH / dt:.3f} images/s, loss "
            f"{loss:.6f}, launches {counts} (expected {expect}), flash forward by path "
            f"{paths}, GN by route {gn_routes} [{state.get('card')}]")
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


# ---- main_launch: the training launcher and its data path ----------------------------------

def _grad_agreement(g_kern, g_plain):
    """(cosine, relative L2) of two gradient dicts over every tensor, in f64."""
    if set(g_kern) != set(g_plain):
        raise RuntimeError("the two gradient runs reached different parameters")
    dot = na = nb = nd = 0.0
    for k, a in g_kern.items():
        a, b = a.double(), g_plain[k].double()
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
        nd += float(((a - b) ** 2).sum())
    return dot / math.sqrt(na * nb), math.sqrt(nd / nb)


@contextlib.contextmanager
def _launch_probes(records: list, towers: dict, hashes: bool = False):
    """Time each optimizer step the launcher's Trainer runs (synchronized)
    with its launch counts (zeroed just before it, read just after) and its
    dp all-reduce's seconds (with ``hashes``, the hashes of the parameters
    and the EMA after it), and the device memory around
    ``VDSystem.free_towers`` (the latent cache); the launcher itself is
    driven as a user drives it."""
    import torch
    from vdtpu_torch.parallel.mesh import tree_fingerprint
    from vdtpu_torch.serving.api import VDSystem
    from vdtpu_torch.training import checkpoints, harness
    inner_step, inner_free, inner_snap = (harness.make_train_step, VDSystem.free_towers,
                                          checkpoints.snapshot)

    def make(*a, **kw):
        step = inner_step(*a, **kw)

        def timed(state, x, ctx, t=None, noise=None, gen=None):
            torch.cuda.synchronize()
            _zero_counters(*_train_counters().values())
            t0 = time.perf_counter()
            loss, aux = step(state, x, ctx, t, noise, gen)
            torch.cuda.synchronize()
            c = _train_counters()
            records.append(dict(seconds=time.perf_counter() - t0, loss=float(loss),
                                comm_s=step.comm_s,
                                launches={k: f.launches for k, f in c.items()},
                                flash_fwd_by_path=dict(c["flash_fwd"].launches_by_path),
                                flash_bwd_by_path=dict(c["flash_bwd"].launches_by_path)))
            if hashes:
                records[-1].update(params_hash=tree_fingerprint(state.params),
                                   ema_hash=tree_fingerprint(state.ema.shadow))
            return loss, aux
        timed.comm_s = 0.0
        return timed

    def free(self):
        torch.cuda.synchronize()
        towers["gn_encode"] = _train_counters()["gn_silu"].launches
        towers["before_gib"] = torch.cuda.memory_allocated() / 2**30
        inner_free(self)
        towers["after_gib"] = torch.cuda.memory_allocated() / 2**30

    def snap(state, *mesh):
        t0 = time.perf_counter()
        out = inner_snap(state, *mesh)
        towers.setdefault("snapshot_s", []).append(time.perf_counter() - t0)
        return out

    harness.make_train_step, VDSystem.free_towers, checkpoints.snapshot = make, free, snap
    try:
        yield
    finally:
        harness.make_train_step, VDSystem.free_towers, checkpoints.snapshot = (
            inner_step, inner_free, inner_snap)


@contextlib.contextmanager
def _no_saves():
    """The Trainer saves nothing (the resume-equivalence rerun, whose
    files would only cost disk)."""
    from vdtpu_torch.training import harness
    inner = harness.Trainer._save
    harness.Trainer._save = lambda self, tag: None
    try:
        yield
    finally:
        harness.Trainer._save = inner


def _launch_config(root: str, pretrained: str, vocab: str, merges: str) -> dict:
    """The (b) experiment: vdtpu/config/experiments/vd_laion_t2i.yaml's t2i
    run on the synthesized shards, cut to LAUNCH_ITERS steps of global batch
    LAUNCH_BATCH."""
    from vdtpu_torch.config.experiments import load_experiment
    cfg = load_experiment("vd_laion_t2i")
    cfg.update(name="main_launch", pretrained=pretrained, clip_vocab=vocab, clip_merges=merges,
               model_args=_launch_model_args())
    cfg["data"].update(shards=os.path.join(root, "shards"), batch_size=LAUNCH_BATCH,
                       shuffle_buffer=16, cache_latents=LAUNCH_CACHE, encode_chunk=LAUNCH_CHUNK)
    cfg["train"].update(num_iters=LAUNCH_ITERS, batch_size=LAUNCH_BATCH, ckpt_every=2,
                        async_ckpt=True, freeze=list(TRAIN_FREEZE), log_every=1)
    cfg["train"]["optimizer_args"]["mu_dtype"] = "bfloat16"
    cfg["eval"] = {"ddim_steps": STEPS, "scale": 7.5, "latent_size": 64, "latent_dim": 4,
                   "evaluator": "clip_similarity", "sampler": "ddim", "max_batches": 1,
                   "use_ema": True, "seed": SEED}
    return cfg


def _launch_model_args() -> dict:
    """model_args of the depth cut (LAUNCH_LEVELS): the four-flow config's
    diffuser_cfg_list with the levels replaced."""
    from vdtpu_torch.config.configs import model_cfg_bank
    diffusers = model_cfg_bank()("vd_four_flow_v1-0")["args"]["diffuser_cfg_list"]
    for name, sub in diffusers:
        sub["args"].update(LAUNCH_LEVELS[name])
    return {"diffuser_cfg_list": diffusers}


def _flash_sites(model, latent: int = 64) -> int:
    """Flash launches of one t2i UNet call's forward: the image program's
    context slots on maps of >= 1024 tokens (self-attention over as many
    keys; the 77-token cross-attentions take the plain path)."""
    prog = model.diffuser["image"].program
    side, di, n = latent, 0, 0
    for tok in prog.layer_order:
        if tok == "d":
            kind = prog.data[di].kind
            side = side // 2 if kind == "down" else side * 2 if kind == "up" else side
            di += 1
        elif tok == "c":
            n += side * side >= 1024
    return n


def _edit_run_config(run: str, **sections):
    path = os.path.join(run, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    for sec, kv in sections.items():
        cfg[sec].update(kv)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)


def _check_steps(label: str, records: list, expect: dict, path: str = "wgmma"):
    """Every step's loss finite, launches as derived, the attention on ``path``."""
    for i, r in enumerate(records):
        if not math.isfinite(r["loss"]):
            raise RuntimeError(f"{label} step {i + 1}: loss {r['loss']}")
        if r["launches"] != expect:
            raise RuntimeError(f"{label} step {i + 1}: launches {r['launches']} != {expect}")
        for key in ("flash_fwd_by_path", "flash_bwd_by_path"):
            if sum(r[key].values()) != r[key][path]:
                raise RuntimeError(f"{label} step {i + 1}: {key} {r[key]}, not all {path}")


def _n_gn(model, x_type: str = "image", c_type: str = "text") -> int:
    """GroupNorm calls of one UNet call of the (x_type, c_type) flow."""
    from vdtpu_torch.models.layers import GroupNorm32
    count = lambda mod: sum(isinstance(m, GroupNorm32) for m in mod.modules())
    return (count(model.diffuser[x_type].data_blocks)
            + count(model.diffuser[c_type].context_blocks))


def _launch_data(state, root: str) -> dict:
    """(a) PNG shards (LAUNCH_SHARDS x LAUNCH_PER_SHARD at 512^2, the last
    LAUNCH_OTHER at another size) and data.benchmark's images/s (host work)."""
    from vdtpu_torch.data import benchmark
    t = time.perf_counter()
    shards = benchmark.synthesize_shards(os.path.join(root, "shards"), LAUNCH_SHARDS,
                                         LAUNCH_PER_SHARD, 512, fmt="png", n_other=LAUNCH_OTHER)
    synth_s = time.perf_counter() - t
    rates = {th: benchmark.run(shards, 512, LAUNCH_BATCH, th, max_batches=4) for th in (1, 4)}
    nbytes = sum(os.path.getsize(os.path.join(shards, f)) for f in os.listdir(shards))
    log(f"main_launch (a) {LAUNCH_SHARDS} PNG shards x {LAUNCH_PER_SHARD} samples at 512^2 "
        f"({LAUNCH_OTHER} at {512 * 5 // 4}x{512 * 9 // 8}, resized), {nbytes / 2**20:.1f} MiB, "
        f"made in {synth_s:.1f} s; data.benchmark (host decode + resize, batch {LAUNCH_BATCH}): "
        f"{rates[1]:.1f} images/s at 1 thread, {rates[4]:.1f} at 4 (host work: no card) "
        f"[{state.get('card')}]")
    return dict(synth_s=synth_s, images_per_s=rates, shard_mib=nbytes / 2**20)


def _launch_train(state, root: str, cfg_path: str, pretrained: str) -> tuple:
    """(b) the launcher's run: returns (its log, the run dir)."""
    import gc
    import torch
    from vdtpu_torch.training.ema import tree_items
    from vdtpu_torch.training.launch import main as launch_main
    from vdtpu_torch.training.optim import parameter_group_of
    records, towers = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(*_train_counters().values())
    t = time.perf_counter()
    with _launch_probes(records, towers):
        out = launch_main(["--config", cfg_path, "--debug"])
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer, exp = out["trainer"], out["exp"]
    n_gn, n_fl = _n_gn(trainer.model), _flash_sites(trainer.model)
    expect = {"flash_fwd": n_fl * TRAIN_ACCUM, "flash_bwd": n_fl * TRAIN_ACCUM,
              "gn_silu": n_gn * TRAIN_ACCUM}
    _check_steps("main_launch (b)", records, expect)
    files = sorted(os.listdir(exp.weight_dir))
    sd = torch.load(pretrained, map_location="cpu", mmap=True, weights_only=True)
    params = dict(tree_items(trainer.state.params))
    frozen = {k for k in params if parameter_group_of(k) in TRAIN_FREEZE}
    moved, frozen_moved, grads = set(), set(), set()
    for k, p in params.items():
        if p.grad is not None:
            grads.add(k)
        if "diffuser." + k in sd and not torch.equal(p.detach().cpu(), sd["diffuser." + k].float()):
            (frozen_moved if k in frozen else moved).add(k)
    warm = records[1:]
    step_s = sum(r["seconds"] for r in warm) / len(warm)
    res = dict(wall_s=wall, peak_gib=peak, cold_step_s=records[0]["seconds"], warm_step_s=step_s,
               losses=[r["loss"] for r in records], launches_per_step=records[-1]["launches"],
               towers_gib=(towers["before_gib"], towers["after_gib"]),
               gn_encode=towers["gn_encode"], snapshot_s=towers.get("snapshot_s"),
               files=files, moved=len(moved), frozen_moved=len(frozen_moved))
    log(f"main_launch (b) launcher run (vd_laion_t2i at full width, 512^2, bf16 compute, "
        f"global batch {LAUNCH_BATCH}, gradacc {TRAIN_ACCUM}, cache {LAUNCH_CACHE} batches in "
        f"chunks of {LAUNCH_CHUNK}, {LAUNCH_ITERS} steps, async saves every 2): {wall:.1f} s; "
        f"losses {res['losses']}; steps cold {records[0]['seconds']:.3f} s, warm {step_s:.3f} s "
        f"({LAUNCH_BATCH / step_s:.3f} images/s); peak {peak:.2f} GiB; device memory around "
        f"free_towers {towers['before_gib']:.2f} -> {towers['after_gib']:.2f} GiB; GN launches "
        f"of the cache's encodes {towers['gn_encode']}; host snapshots {towers.get('snapshot_s')} "
        f"s; launches a step {records[-1]['launches']} (expected {expect}), flash forward by "
        f"path {records[-1]['flash_fwd_by_path']}; checkpoints {files}; tensors moved "
        f"{len(moved)} (with gradients {len(grads)}), frozen moved {len(frozen_moved)} of "
        f"{len(frozen)} [{state.get('card')}]")
    if frozen_moved or not grads or not grads <= moved:
        raise RuntimeError(f"main_launch (b): frozen moved {sorted(frozen_moved)[:3]}, with "
                           f"gradients not moved {sorted(grads - moved)[:3]}")
    if files != ["iter_2.pt", "iter_4.pt", "last.pt"]:
        raise RuntimeError(f"main_launch (b): checkpoints {files}")
    if not towers["after_gib"] < towers["before_gib"]:
        raise RuntimeError("main_launch (b): the towers' memory was not freed")
    lrs = [trainer.scheduler[s // TRAIN_ACCUM] for s in range(LAUNCH_ITERS)]
    del out, trainer, params, sd
    gc.collect()
    torch.cuda.empty_cache()
    return res, exp.log_dir, lrs


def _launch_resume(state, cfg_path: str, run: str, lrs) -> dict:
    """(c) the rerun from iter_2 to step LAUNCH_ITERS (no saves) against (b)'s
    step-LAUNCH_ITERS parameters, then the resume to LAUNCH_RESUME_ITERS."""
    import gc
    import torch
    from vdtpu_torch.training.ema import tree_items
    from vdtpu_torch.training.launch import main as launch_main
    weight = os.path.join(run, "weight")
    records, towers = [], {}
    with _launch_probes(records, towers), _no_saves():
        out = launch_main(["--config", cfg_path, "--resume_dir", run, "--resume_weight", "iter_2"])
    ref = torch.load(os.path.join(weight, f"iter_{LAUNCH_ITERS}.pt"), map_location="cpu",
                     mmap=True, weights_only=True)["params"]
    bound = LAUNCH_RESUME_BOUND * sum(lrs[2:])
    worst, n_diff, n_all = 0.0, 0, 0
    for k, p in tree_items(out["trainer"].state.params):
        d = (p.detach().float().cpu() - ref[k].float()).abs()
        worst = max(worst, float(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
    rerun_steps = [r["seconds"] for r in records]
    del out, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"main_launch (c) from iter_2 to step {LAUNCH_ITERS} again: {n_diff} of {n_all} "
        f"parameter elements differ from (b)'s, max |diff| {worst:.3e} (bound "
        f"{LAUNCH_RESUME_BOUND} x the two steps' lr sum = {bound:.3e}: Adam moves an element by "
        f"about lr a step, and a gradient at rounding level, whose dQ partials add in no fixed "
        f"order on the card, may flip its sign); steps {rerun_steps} s [{state.get('card')}]")
    if not worst <= bound:
        raise RuntimeError(f"main_launch (c): the rerun from iter_2 is {worst:.3e} from (b)'s "
                           f"parameters, over {bound:.3e}")
    for tag in ("iter_2", f"iter_{LAUNCH_ITERS}"):   # 'last' stays (the same file)
        os.remove(os.path.join(weight, f"{tag}.pt"))

    _edit_run_config(run, train={"num_iters": LAUNCH_RESUME_ITERS})
    records.clear()
    t = time.perf_counter()
    with _launch_probes(records, towers):
        out = launch_main(["--config", cfg_path, "--resume_dir", run])
    wall = time.perf_counter() - t
    step = out["trainer"].state.step
    with open(os.path.join(run, "train.log")) as f:
        resumed = [ln for ln in f if ln.startswith("resumed from")]
    files = sorted(os.listdir(weight))
    n_fl = _flash_sites(out["trainer"].model)
    expect = {"flash_fwd": n_fl * TRAIN_ACCUM, "flash_bwd": n_fl * TRAIN_ACCUM,
              "gn_silu": _n_gn(out["trainer"].model) * TRAIN_ACCUM}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    _check_steps("main_launch (c)", records, expect)
    log(f"main_launch (c) resume to {LAUNCH_RESUME_ITERS}: {wall:.1f} s, log {resumed!r}, "
        f"step {step}, losses {[r['loss'] for r in records]}, steps "
        f"{[round(r['seconds'], 3) for r in records]} s, checkpoints {files} "
        f"[{state.get('card')}]")
    if (not resumed or f"at step {LAUNCH_ITERS}" not in resumed[-1]
            or step != LAUNCH_RESUME_ITERS or f"iter_{LAUNCH_RESUME_ITERS}.pt" not in files):
        raise RuntimeError(f"main_launch (c): resume log {resumed}, step {step}, files {files}")
    os.remove(os.path.join(weight, f"iter_{LAUNCH_RESUME_ITERS}.pt"))
    return dict(rerun_max_diff=worst, rerun_bound=bound, rerun_elements_differ=n_diff,
                resume_wall_s=wall, resume_steps_s=[r["seconds"] for r in records])


def _launch_eval(state, cfg_path: str, run: str) -> dict:
    """(d) --eval on the run's EMA shadow: one batch of 2, DDIM-50, CFG 7.5."""
    import gc
    import torch
    from vdtpu_torch.serving.api import VDSystem
    from vdtpu_torch.training.launch import main as launch_main
    _edit_run_config(run, data={"batch_size": 2})
    meta = VDSystem("vd_four_flow_v1-0", device="meta", model_args=_launch_model_args())
    n_unet, n_dec, _ = _gn_sites(meta)
    expect = {"flash_fwd": _flash_sites(meta.model) * STEPS, "gn_silu": n_unet * STEPS + n_dec}
    del meta
    torch.cuda.synchronize()
    _zero_counters()
    t = time.perf_counter()
    summary = launch_main(["--config", cfg_path, "--eval", "--resume_dir", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {k: _read_counters()[k] for k in expect}
    paths = _wgmma_only("main_launch (d)")["flash_fwd"]
    with open(os.path.join(run, "eval", "summary.yaml")) as f:
        text = f.read()
    written = {k.strip(): float(v) for k, v in (ln.split(":", 1) for ln in text.splitlines())}
    with open(os.path.join(run, "train.log")) as f:   # the resumed run's log
        loaded = "eval: loaded trained checkpoint 'last'" in f.read()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"main_launch (d) --eval (EMA shadow of 'last'; 1 batch of 2, DDIM-{STEPS}, CFG 7.5, "
        f"CLIP-sim): {wall:.1f} s, summary.yaml {text.strip()!r}, checkpoint loaded {loaded}, "
        f"launches {got} (expected {expect}), flash by path {paths} [{state.get('card')}]")
    if (written != {k: float(v) for k, v in summary.items()}
            or not all(math.isfinite(v) for v in written.values()) or not loaded):
        raise RuntimeError(f"main_launch (d): summary {written} / {summary}, loaded {loaded}")
    if got != expect:
        raise RuntimeError(f"main_launch (d): launches {got} != {expect}")
    return dict(wall_s=wall, summary=written, launches=got)


def _launch_flows(state) -> dict:
    """(e)-(h) on one full-width f32 system of three levels (LAUNCH_LEVELS)
    with the Optimus VAE."""
    import gc
    import torch
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from vdtpu_torch.serving.api import VDSystem
    from vdtpu_torch.training.harness import Trainer, make_loss_fn
    from vdtpu_torch.training.optim import get_optimizer
    from vdtpu_torch.training.schedulers import get_scheduler
    res = {}
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.float32, device="cuda",
                      use_checkpoint=False, model_args=_launch_model_args())
    system.init_random(SEED + 20)
    derandomize_zeros(system.net, SEED + 21)
    model = system.model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    prompts = [f"a photo of a {w} on a table in the morning light" for w in (
        "cat", "dog", "red apple", "blue cup", "lamp", "book", "violin", "plant")]
    ctx_ids = stand_in_tokenizer(prompts)
    ctx = system.ctx_encode(ctx_ids, "text")
    with torch.no_grad():
        bert = system.vae["text"].encoder.embeddings.word_embeddings.num_embeddings
        ids = torch.randint(1000, bert, (LAUNCH_BATCH, 32), device="cuda", generator=gen)
        x_text = model.scale_latent(system.vae["text"].encode_ids(ids), "text").float()
    x_img = torch.randn(LAUNCH_BATCH, 4, 64, 64, device="cuda", generator=gen)
    sched = get_scheduler({"type": "stable_diffusion_linear", "base_lr": 1e-7},
                          global_batch_size=LAUNCH_BATCH, gradacc_every=TRAIN_ACCUM)

    def trainer_steps(label, tree, x, ctx_in, x_type, c_type, expect, freeze=TRAIN_FREEZE,
                      **kw):
        opt, set_lr = get_optimizer("adamw", tree, TRAIN_PG_LRSCALE, freeze, weight_decay=0.01)
        tr = Trainer(model, tree, opt, set_lr, sched, x_type=x_type, c_type=c_type,
                     ema_decay=0.9999, grad_accum=TRAIN_ACCUM, freeze_groups=freeze,
                     log_every=1, **kw)
        times = []
        for i in range(2):
            torch.cuda.synchronize()
            _zero_counters(*_train_counters().values())
            t = time.perf_counter()
            tr.run([{"x": x, "ctx": ctx_in}] * 2, num_iters=i + 1, seed=SEED)
            loss = tr.last_loss
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got = {k: c.launches for k, c in _train_counters().items()}
            if not math.isfinite(loss) or got != expect:
                raise RuntimeError(f"main_launch {label} step {i + 1}: loss {loss}, launches "
                                   f"{got} != {expect}")
        return tr, opt, times

    # (h) f32 compute: the tf32x3 route at the 4096- and 1024-token sites
    params = system.for_training(torch.float32)
    t_mb = torch.tensor([100, 700], device="cuda")
    noise = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
    with _no_tf32():
        loss_fn = make_loss_fn(model, "image", "text", TRAIN_FREEZE)
        _zero_counters(flash_attention_bwd)
        g_kern, loss_k, counts_k = _train_grads(loss_fn, params, x_img[:2], ctx[:2], t_mb, noise)
        f32_paths = (dict(flash_attention.launches_by_path),
                     dict(flash_attention_bwd.launches_by_path))
        with _plain_kernels():
            g_plain, loss_p, counts_p = _train_grads(loss_fn, params, x_img[:2], ctx[:2], t_mb,
                                                     noise)
    cos, rel = _grad_agreement(g_kern, g_plain)
    del g_kern, g_plain
    n_gn, n_fl = _n_gn(model), _flash_sites(model)
    expect_h = {"flash_fwd": n_fl, "flash_bwd": n_fl, "gn_silu": n_gn}
    log(f"main_launch (h) f32 compute (bf16: false), micro-batch-2 gradient, kernels vs plain "
        f"(TF32 off): cosine {cos:.8f} rel_l2 {rel:.3e} (limits cos >= {TRAIN_MIN_COS}, rel_l2 "
        f"<= {TRAIN_MAX_REL_L2}); loss {loss_k:.7f} vs {loss_p:.7f}; launches {counts_k} "
        f"(expected {expect_h}), forward by path {f32_paths[0]}, backward by path "
        f"{f32_paths[1]}; plain run {counts_p} [{state.get('card')}]")
    if not (cos >= TRAIN_MIN_COS and rel <= TRAIN_MAX_REL_L2) or counts_k != expect_h \
            or f32_paths[0]["tf32x3"] != n_fl or f32_paths[1]["tf32x3"] != n_fl \
            or sum(f32_paths[0].values()) != n_fl or sum(f32_paths[1].values()) != n_fl \
            or any(counts_p.values()):
        raise RuntimeError("main_launch (h): the f32 route's gradient or launches disagree")
    res["h"] = dict(cosine=cos, rel_l2=rel, launches=counts_k, fwd_by_path=f32_paths[0],
                    bwd_by_path=f32_paths[1])
    for name, n in (("flash_fwd_tf32x3", f32_paths[0]["tf32x3"]),
                    ("flash_bwd_tf32x3", f32_paths[1]["tf32x3"])):
        if name in state["kernels"]:
            k = state["kernels"][name]
            k["launches_main_launch_h"] = n
            if not k["launches"]:
                k["launches"] = n
                k["path"] = "main_launch (h): f32 micro-batch-2 gradient"
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the text flow: Optimus latents, the text diffuser, bf16 compute
    params = system.for_training(torch.bfloat16)
    loss_fn = make_loss_fn(model, "text", "text")
    noise_t = torch.randn(2, x_text.shape[1], device="cuda", generator=gen)
    g_kern, loss_k, counts_k = _train_grads(loss_fn, params, x_text[:2], ctx[:2], t_mb, noise_t)
    with _plain_kernels():
        g_plain, loss_p, counts_p = _train_grads(loss_fn, params, x_text[:2], ctx[:2], t_mb,
                                                 noise_t)
    cos, rel = _grad_agreement(g_kern, g_plain)
    del g_kern, g_plain
    n_gn_t = _n_gn(model, "text", "text")
    expect_e = {"flash_fwd": 0, "flash_bwd": 0, "gn_silu": n_gn_t}
    log(f"main_launch (e) text flow (x_type text, c_type text; Optimus latents {tuple(x_text.shape)}"
        f"), micro-batch-2 gradient, kernels vs plain: cosine {cos:.6f} rel_l2 {rel:.5f}; loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; launches {counts_k} (expected {expect_e}: the GN "
        f"kernel at the text diffuser's sites, no attention over 1024 keys) "
        f"[{state.get('card')}]")
    if not (cos >= TRAIN_MIN_COS and rel <= TRAIN_MAX_REL_L2) or counts_k != expect_e:
        raise RuntimeError("main_launch (e): the text flow's gradient or launches disagree")
    tr, opt, times = trainer_steps("(e)", params, x_text, ctx, "text", "text",
                                   {k: v * TRAIN_ACCUM for k, v in expect_e.items()},
                                   freeze=("diffuser_image_data",))
    res["e"] = dict(cosine=cos, rel_l2=rel, launches=counts_k, step_s=times)
    log(f"main_launch (e) two Trainer steps of the text flow: {times} s, loss "
        f"{tr.last_loss:.6f} [{state.get('card')}]")
    del tr, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the trainable CLIP text tower inside the loss
    cparams, encode = system.trainable_ctx("text", torch.bfloat16)
    before = {k: _fingerprint(p) for k, p in cparams.items()}
    tree = {"diffuser": params, "ctx": cparams}
    expect_f = {"flash_fwd": n_fl * TRAIN_ACCUM, "flash_bwd": n_fl * TRAIN_ACCUM,
                "gn_silu": n_gn * TRAIN_ACCUM}
    torch.cuda.reset_peak_memory_stats()
    tr, opt, times = trainer_steps("(f)", tree, x_img, torch.as_tensor(ctx_ids), "image", "text",
                                   expect_f, ctx_encode_fn=encode)
    with_grad = {k for k, p in cparams.items() if p.grad is not None}
    moved = {k for k, p in cparams.items() if _fingerprint(p) != before[k]}
    labels = sorted({g["label"] for g in opt.param_groups})
    peak_f = torch.cuda.max_memory_allocated() / 2**30
    log(f"main_launch (f) trainable CLIP text tower: two t2i steps {times} s, loss "
        f"{tr.last_loss:.6f}, tower tensors with gradients {len(with_grad)} of {len(cparams)}, "
        f"moved {len(moved)}, optimizer groups {labels}, peak {peak_f:.2f} GiB "
        f"[{state.get('card')}]")
    if not with_grad or not with_grad <= moved:
        raise RuntimeError(f"main_launch (f): tower tensors with gradients not moved "
                           f"{sorted(with_grad - moved)[:3]}")
    res["f"] = dict(step_s=times, tower_moved=len(moved), tower_with_grad=len(with_grad),
                    tower_tensors=len(cparams), peak_gib=peak_f)
    del tr, opt, tree, cparams, encode
    system.ctx["text"].requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()

    # (g) bf16 master weights
    params = system.for_training(torch.bfloat16, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    tr, opt, times = trainer_steps("(g)", params, x_img, ctx, "image", "text", expect_f)
    peak_g = torch.cuda.max_memory_allocated() / 2**30
    dtypes = sorted({str(st["mu"].dtype) for st in opt.state.values()}
                    | {str(s.dtype) for s in tr.state.ema.shadow.values()})
    log(f"main_launch (g) params_dtype bfloat16: two t2i steps {times} s, loss "
        f"{tr.last_loss:.6f}, moments and shadow {dtypes}, peak {peak_g:.2f} GiB "
        f"[{state.get('card')}]")
    if dtypes != ["torch.bfloat16"]:
        raise RuntimeError(f"main_launch (g): state dtypes {dtypes}")
    res["g"] = dict(step_s=times, peak_gib=peak_g)
    del tr, opt, params, system, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_main_launch(state):
    """The training launcher (python -m vdtpu_torch.training.launch) at full
    width through its data path: (a) shards and data.benchmark, (b) a run,
    (c) a rerun from iter_2 and a resume, (d) --eval, then (e)-(h) the text
    flow, the trainable context encoder, bf16 master weights and f32
    compute on a system of their own."""
    import gc
    import shutil
    import torch
    state.pop("system", None)
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.abspath(LAUNCH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {"a": _launch_data(state, root)}
    from vdtpu_torch.serving.api import VDSystem
    t = time.perf_counter()
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.float32, device="cuda",
                      model_args=_launch_model_args())
    system.init_random(SEED)
    derandomize_zeros(system.net, SEED + 1)
    pretrained = os.path.join(root, "pretrained.pt")
    torch.save({k: v.to("cpu", torch.bfloat16) for k, v in system.net.state_dict().items()},
               pretrained)
    del system
    gc.collect()
    torch.cuda.empty_cache()
    vocab, merges = os.path.join(root, "vocab.json"), os.path.join(root, "merges.txt")
    _synthetic_clip_vocab(vocab, merges)
    cfg_path = os.path.join(root, "experiment.json")
    with open(cfg_path, "w") as f:
        json.dump(_launch_config(root, pretrained, vocab, merges), f, indent=1)
    log(f"main_launch: pretrained {os.path.getsize(pretrained) / 2**30:.2f} GiB (bf16, seeded) "
        f"written in {time.perf_counter() - t:.1f} s")
    cwd = os.getcwd()
    os.chdir(root)      # the run dir goes under <root>/log
    try:
        res["b"], run, lrs = _launch_train(state, root, cfg_path, pretrained)
        res["c"] = _launch_resume(state, cfg_path, run, lrs)
        res["d"] = _launch_eval(state, cfg_path, run)
    finally:
        os.chdir(cwd)
    shutil.rmtree(os.path.join(root, "log"), ignore_errors=True)  # tens of GiB of checkpoints
    state["launch_files"] = (pretrained, vocab, merges)   # main_parallel takes them
    res.update(_launch_flows(state))
    log(f"main_launch: peak (b) {res['b']['peak_gib']:.2f} GiB (f32 master weights), (g) "
        f"{res['g']['peak_gib']:.2f} GiB (bf16 master weights) [{state.get('card')}]")
    state["main_launch"] = res


# ---- main_parallel ---------------------------------------------------------------------

def _launch_worker(argv: list[str]) -> int:
    """``chip_smoke.py --launch-worker OUT <launcher args>``, run by torchrun
    on every rank: the launcher's ``main`` as a user runs it under
    ``_launch_probes`` (steps timed and hashed), no checkpoint written;
    writes ``OUT.rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from vdtpu_torch.training.launch import main as launch_main
    out = argv[argv.index("--launch-worker") + 1]
    records = []
    torch.cuda.reset_peak_memory_stats()
    with _launch_probes(records, {}, hashes=True), _no_saves():
        launch_main(argv[argv.index("--launch-worker") + 2:])
    rank = dist.get_rank() if dist.is_initialized() else 0
    res = dict(rank=rank, backend=dist.get_backend() if dist.is_initialized() else None,
               records=records, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _spawn_ranks(label: str, cmd: list, cwd: str | None = None) -> dict:
    """Start one multi-process command (torchrun, or the dry run) in a
    session of its own, output to chiprun_out/main_parallel_<label>.log;
    ``_reap_ranks`` waits for it."""
    path = os.path.abspath(os.path.join("chiprun_out", f"main_parallel_{label}.log"))
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    os.makedirs(cwd or repo, exist_ok=True)
    with open(path, "w") as f:
        p = subprocess.Popen(cmd, cwd=cwd or repo, stdout=f, stderr=subprocess.STDOUT, env=env,
                             start_new_session=True)
    return dict(label=label, proc=p, path=path, t0=time.perf_counter())


def _reap_ranks(job: dict, timeout: float = PAR_TIMEOUT) -> tuple[str, float]:
    """Wait for a ``_spawn_ranks`` command until ``timeout`` seconds after its
    start. A nonzero exit or the timeout fails the phase; every process of
    its session is killed either way. Returns (the output, seconds), kept
    in the job for a second call."""
    import signal
    if "result" in job:
        return job["result"]
    p, label = job["proc"], job["label"]
    try:
        rc = p.wait(timeout=max(1.0, job["t0"] + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    wall = time.perf_counter() - job["t0"]
    with open(job["path"]) as f:
        out = f.read()
    if rc is None:
        raise RuntimeError(f"main_parallel {label}: no end after {timeout} s (every rank "
                           f"killed): {out[-2000:]}")
    if rc != 0:
        raise RuntimeError(f"main_parallel {label}: exit {rc}: {out[-3000:]}")
    job["result"] = out, wall
    return out, wall


def _reap_all(jobs: list) -> list:
    """``_reap_ranks`` of every job, in order; if one fails, the others are
    killed too before the failure propagates."""
    out = []
    try:
        for job in jobs:
            out.append(_reap_ranks(job))
    finally:
        for job in jobs[len(out):]:
            with contextlib.suppress(Exception):
                job["t0"] = -PAR_TIMEOUT        # no wait: kill now
                _reap_ranks(job)
    return out



def _uniform_shards(root: str) -> str:
    """PAR_SHARDS tar shards of PAR_PER_SHARD samples, every one the same
    seeded 512^2 PNG and caption."""
    import io
    import tarfile
    import numpy as np
    from vdtpu_torch.data.images import encode_png
    os.makedirs(root, exist_ok=True)
    rgb = np.random.RandomState(SEED + 30).randint(0, 256, (512, 512, 3), dtype=np.uint8)
    png, caption = encode_png(rgb), b"a red cat sitting on a wooden bench in the sun"
    for s in range(PAR_SHARDS):
        with tarfile.open(os.path.join(root, f"shard-{s:04d}.tar"), "w") as tf:
            for i in range(PAR_PER_SHARD):
                for ext, data in (("png", png), ("txt", caption)):
                    info = tarfile.TarInfo(f"{s:04d}{i:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return root


def _parallel_setup(state, root: str) -> str:
    """The experiment of (a) and (b): main_launch's (its pretrained weights,
    written again when main_launch did not run here) on the uniform shards,
    PAR_ITERS steps, no checkpoint cadence. Returns its path."""
    import gc
    import torch
    from vdtpu_torch.serving.api import VDSystem
    os.makedirs(root, exist_ok=True)
    files = state.get("launch_files")
    if files is None or not os.path.exists(files[0]):
        system = VDSystem("vd_four_flow_v1-0", dtype=torch.float32, device="cuda",
                          model_args=_launch_model_args())
        system.init_random(SEED)
        derandomize_zeros(system.net, SEED + 1)
        files = (os.path.join(root, "pretrained.pt"), os.path.join(root, "vocab.json"),
                 os.path.join(root, "merges.txt"))
        torch.save({k: v.to("cpu", torch.bfloat16) for k, v in system.net.state_dict().items()},
                   files[0])
        _synthetic_clip_vocab(files[1], files[2])
        del system
        gc.collect()
        torch.cuda.empty_cache()
    cfg = _launch_config(root, *files)
    cfg.update(name="main_parallel", with_text_vae=False)
    cfg["data"]["shards"] = _uniform_shards(os.path.join(root, "shards"))
    cfg["train"].update(num_iters=PAR_ITERS, ckpt_every=None, async_ckpt=False)
    cfg["data"]["cache_latents"] = PAR_CACHE
    path = os.path.join(root, "experiment.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def _worker_spawn(root: str, cfg_path: str, nproc: int, label: str) -> dict:
    """Start the launcher under torchrun with ``nproc`` ranks on the card (a
    run dir of its own under ``root``)."""
    out = os.path.join(root, f"worker_{label}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--launch-worker", out, "--config",
           cfg_path, "--debug"]
    return dict(_spawn_ranks(label, cmd, cwd=os.path.join(root, f"cwd_{label}")), out=out,
                nproc=nproc)


def _worker_runs(job: dict) -> dict:
    """The ranks' records of a ``_worker_spawn`` run, once it ended."""
    text, wall = _reap_ranks(job)
    out, nproc = job["out"], job["nproc"]
    ranks = []
    for r in range(nproc):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    backend = re.findall(r"distributed: backend (\w+), world (\d+)", text)
    return dict(ranks=ranks, wall_s=wall, printed=backend)


def _par_expect(model_args=None, accum: int = TRAIN_ACCUM) -> dict:
    """Flash and GN launches of one training step of a rank (no remat)."""
    from vdtpu_torch.serving.api import VDSystem
    meta = VDSystem("vd_four_flow_v1-0", device="meta", model_args=model_args)
    n_fl, n_gn = _flash_sites(meta.model), _n_gn(meta.model)
    return {"flash_fwd": n_fl * accum, "flash_bwd": n_fl * accum, "gn_silu": n_gn * accum}


def _parallel_launcher(state, root: str) -> dict:
    """(a) torchrun, NCCL, world 1; (b) torchrun, two ranks over gloo: both
    at once, each in a run dir of its own (three processes sharing the
    card; their step times are not the card's alone)."""
    cfg_path = _parallel_setup(state, root)
    expect = _par_expect(_launch_model_args())
    res = {}
    jobs = [_worker_spawn(root, cfg_path, nproc, label) for label, nproc in (("a", 1), ("b", 2))]
    _reap_all(jobs)
    for job in jobs:
        label = job["label"]
        run = _worker_runs(job)
        for r in run["ranks"]:
            _check_steps(f"main_parallel ({label}) rank {r['rank']}", r["records"], expect)
            if len(r["records"]) != PAR_ITERS:
                raise RuntimeError(f"main_parallel ({label}): {len(r['records'])} steps")
        res[label] = run
    a, b = res["a"]["ranks"][0], res["b"]["ranks"]
    loss_a = [s["loss"] for s in a["records"]]
    loss_b = [sum(r["records"][i]["loss"] for r in b) / len(b) for i in range(PAR_ITERS)]
    rel = [abs(x - y) / abs(y) for x, y in zip(loss_b, loss_a)]
    hashes = [[(s["params_hash"], s["ema_hash"]) for s in r["records"]] for r in b]
    log(f"main_parallel (a) torchrun --nproc_per_node 1 -m-style launcher run (main_launch's "
        f"experiment, three levels, global batch {LAUNCH_BATCH}, gradacc {TRAIN_ACCUM}, "
        f"uniform shards): printed {res['a']['printed']}, backend {a['backend']}, losses "
        f"{loss_a}, steps {[round(s['seconds'], 3) for s in a['records']]} s, peak "
        f"{a['peak_gib']:.2f} GiB, launches a step {a['records'][-1]['launches']} "
        f"(expected {expect}), {res['a']['wall_s']:.1f} s in all [{state.get('card')}]")
    for r in b:
        warm = r["records"][1:]
        step = sum(s["seconds"] for s in warm) / len(warm)
        comm = sum(s["comm_s"] for s in warm) / len(warm)
        log(f"main_parallel (b) dp = 2, two ranks sharing the card over {r['backend']}: rank "
            f"{r['rank']} losses {[s['loss'] for s in r['records']]}, steps "
            f"{[round(s['seconds'], 3) for s in r['records']]} s (warm {step:.3f} s, of it the "
            f"all-reduce {comm:.3f} s = {comm / step:.3f}), peak {r['peak_gib']:.2f} GiB "
            f"[{state.get('card')}]")
    log(f"main_parallel (b) mean losses {loss_b} vs (a) {loss_a}: relative {rel} (bound "
        f"{PAR_LOSS_RTOL}); replica hashes equal after every step: "
        f"{all(h == hashes[0] for h in hashes)}; printed {res['b']['printed']}; "
        f"{res['b']['wall_s']:.1f} s in all [{state.get('card')}]")
    if a["backend"] != "nccl" or res["a"]["printed"] != [("nccl", "1")]:
        raise RuntimeError(f"main_parallel (a): backend {a['backend']} {res['a']['printed']}")
    if [r["backend"] for r in b] != ["gloo", "gloo"] or res["b"]["printed"] != [("gloo", "2")]:
        raise RuntimeError(f"main_parallel (b): backends {[r['backend'] for r in b]}")
    if not all(h == hashes[0] for h in hashes):
        raise RuntimeError(f"main_parallel (b): the replicas differ: {hashes}")
    if not all(math.isfinite(x) for x in loss_a + loss_b) or max(rel) > PAR_LOSS_RTOL:
        raise RuntimeError(f"main_parallel (b): losses {loss_b} vs {loss_a}")
    return dict(a_losses=loss_a, b_losses=loss_b, rel=rel,
                b_ranks=[dict(rank=r["rank"], peak_gib=r["peak_gib"],
                              steps_s=[s["seconds"] for s in r["records"]],
                              comm_s=[s["comm_s"] for s in r["records"]]) for r in b],
                a_steps_s=[s["seconds"] for s in a["records"]], a_peak_gib=a["peak_gib"])


def _dryrun_spawn(label: str, root: str, *args) -> dict:
    """Start ``python -m vdtpu_torch.parallel.dryrun`` on the card (gloo, the
    ranks sharing it)."""
    out = os.path.join(root, f"dryrun_{label}")
    cmd = [sys.executable, "-m", "vdtpu_torch.parallel.dryrun", "--device", "cuda",
           "--out", out, "--config", "vd_four_flow_v1-0", "--seed", str(SEED),
           "--image-size", "512", "--latent-downsample", "8", "--timeout",
           str(PAR_TIMEOUT - 20), *args]
    return dict(_spawn_ranks(label, cmd), out=out, nproc=int(args[args.index("--nproc") + 1]))


def _dryrun(job: dict) -> list[dict]:
    """The ranks' results of a ``_dryrun_spawn`` run, once it ended."""
    text, wall = _reap_ranks(job)
    out, n = job["out"], job["nproc"]
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ranks[0]["wall_s"] = wall
    return ranks


def _parallel_dryruns(state, root: str) -> tuple[dict, dict, dict]:
    """(c) and (d) at once (four processes sharing the card; their times are
    not the card's alone), and (e) in this process while they run."""
    margs = os.path.join(root, "model_args.json")
    with open(margs, "w") as f:
        json.dump(_launch_model_args(), f)
    jobs = [_dryrun_spawn("c", root, "--nproc", "2", "--tp", "2", "--phases", "eps,train",
                          "--model-args", margs, "--train-steps", "2", "--batch",
                          str(PAR_TP_BATCH), "--accum", "1", "--compute-dtype", "bfloat16",
                          "--dtype", "bfloat16", "--base-lr", "1e-5", "--reference"),
            _dryrun_spawn("d", root, "--nproc", "2", "--tp", "1", "--phases", "serve",
                          "--steps", str(STEPS), "--dtype", "bfloat16", "--reference",
                          "--model-args", margs)]
    try:
        utilities = _parallel_utilities(state)
    finally:
        _reap_all(jobs)
    return _parallel_tp(state, _dryrun(jobs[0])), _parallel_serve(state, _dryrun(jobs[1])), \
        utilities


def _parallel_tp(state, ranks) -> dict:
    """(c) tp = 2 at three levels: one CFG eps call, then two Trainer steps,
    each against one process on rank 0 (``ranks``: the dry run's results)."""
    from vdtpu_torch.serving.api import VDSystem
    meta = VDSystem("vd_four_flow_v1-0", device="meta", model_args=_launch_model_args())
    expect_eps = {"flash_fwd": _flash_sites(meta.model), "flash_bwd": 0,
                  "gn_silu": _n_gn(meta.model)}
    del meta
    expect = _par_expect(_launch_model_args(), accum=1)
    e0, t0 = ranks[0]["eps"], ranks[0]["train"]
    agree, raw = e0["vs_one_process"], e0["raw_vs_one_process"]
    to32, one32 = e0["vs_f32"], e0["one_process_vs_f32"]
    g, pa = t0["grads_vs_one_process"], t0["params_vs_one_process"]
    steps = [[s["launches"] for s in r["train"]["steps"]] for r in ranks]
    log(f"main_parallel (c) tp = 2 at three levels ({ranks[0]['wall_s']:.1f} s with the ranks' "
        f"start; {ranks[0]['sharded']} tensors sharded): a CFG eps call (batch {PAR_TP_BATCH} x "
        f"CFG, 64^2 latent, bf16): model output vs one process cosine {raw['cosine']:.6f} "
        f"rel_l2 {raw['rel_l2']:.3e} (limits >= {PAR_EPS_MIN_COS}, <= {PAR_EPS_MAX_REL_L2}); "
        f"guided eps vs one process cosine {agree['cosine']:.6f} rel_l2 {agree['rel_l2']:.3e}, "
        f"vs f32 {to32['cosine']:.6f} / {to32['rel_l2']:.3e} beside one process's "
        f"{one32['cosine']:.6f} / {one32['rel_l2']:.3e} (limit {PAR_EPS_F32_RATIO}x); launches "
        f"per rank {[r['eps']['launches'] for r in ranks]} (expected {expect_eps}), seconds "
        f"{[round(r['eps']['seconds'], 3) for r in ranks]}, gathers by route "
        f"{[r['gather_routes'] for r in ranks]} [{state.get('card')}]")
    log(f"main_parallel (c) two Trainer steps (batch {PAR_TP_BATCH}, bf16 compute, f32 masters)"
        f" vs one process: last gradients cosine {g['cosine']:.6f} rel_l2 {g['rel_l2']:.3e}, "
        f"parameters cosine {pa['cosine']:.9f} rel_l2 {pa['rel_l2']:.3e} (limits cos >= "
        f"{TRAIN_MIN_COS}, rel_l2 <= {TRAIN_MAX_REL_L2}); losses "
        f"{[[round(s['loss'], 6) for s in r['train']['steps']] for r in ranks]} vs "
        f"{t0['loss_one_process']:.6f}; steps "
        f"{[[round(s['seconds'], 3) for s in r['train']['steps']] for r in ranks]} s; launches "
        f"a step per rank {steps} (expected {expect}); peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB [{state.get('card')}]")
    if not (raw["cosine"] >= PAR_EPS_MIN_COS and raw["rel_l2"] <= PAR_EPS_MAX_REL_L2
            and to32["rel_l2"] <= PAR_EPS_F32_RATIO * one32["rel_l2"]) or \
            any(r["eps"]["launches"] != expect_eps or not r["eps"]["finite"] for r in ranks):
        raise RuntimeError("main_parallel (c): the tp = 2 eps call disagrees")
    for agreement in (g, pa):
        if not (agreement["cosine"] >= TRAIN_MIN_COS and agreement["rel_l2"] <= TRAIN_MAX_REL_L2):
            raise RuntimeError("main_parallel (c): tp = 2 training disagrees with one process")
    if any(c != expect for r in steps for c in r):
        raise RuntimeError(f"main_parallel (c): launches {steps} != {expect}")
    return dict(eps=agree, eps_raw=raw, eps_vs_f32=to32, eps_one_vs_f32=one32,
                eps_launches=e0["launches"], grads=g, params=pa, train_launches=steps[0][-1],
                routes=ranks[0]["gather_routes"], peak_gib=[r["peak_gib"] for r in ranks],
                wall_s=ranks[0]["wall_s"])


def _parallel_serve(state, ranks) -> dict:
    """(d) dp = 2 serving at three levels: t2i at DDIM-50 on both ranks, the
    queue on a leader and a follower, each image against one process
    (``ranks``: the dry run's results)."""
    from vdtpu_torch.serving.api import VDSystem
    meta = VDSystem("vd_four_flow_v1-0", device="meta", model_args=_launch_model_args())
    n_unet, n_dec, _ = _gn_sites(meta)
    expect = {"flash_fwd": _flash_sites(meta.model) * STEPS, "flash_bwd": 0,
              "gn_silu": n_unet * STEPS + n_dec}
    del meta
    sv = ranks[0]["serve"]
    rows = sv["t2i_vs_one_process"] + sv["queue_vs_one_process"]
    log(f"main_parallel (d) dp = 2 serving at three levels (two ranks sharing the card "
        f"over gloo; "
        f"{ranks[0]['wall_s']:.1f} s with the ranks' start): t2i 2 images "
        f"DDIM-{STEPS} CFG 7.5 {[round(r['serve']['t2i_seconds'], 3) for r in ranks]} s per rank"
        f" vs {sv['t2i_one_process_seconds']:.3f} s in one process (host-bound: each rank runs "
        f"batch 1 and both share the card); queue bucket 2 on the leader {sv['queue_seconds']:.3f}"
        f" s, follower calls {ranks[1]['serve']['followed']}; per image vs one process "
        f"{[(round(r['cosine'], 6), round(r['rel_l2'], 5)) for r in rows]} (limits cos >= "
        f"{QUEUE_MIN_COS}, rel_l2 <= {QUEUE_MAX_REL_L2}); t2i launches per rank "
        f"{[r['serve']['t2i_launches'] for r in ranks]} (expected {expect}: one image a rank); "
        f"peak {[round(r['peak_gib'], 2) for r in ranks]} GiB [{state.get('card')}]")
    if any(not (r["cosine"] >= QUEUE_MIN_COS and r["rel_l2"] <= QUEUE_MAX_REL_L2) for r in rows) \
            or not (sv["t2i_finite"] and sv["queue_finite"]) or len(rows) != 4 \
            or any(r["serve"]["t2i_launches"] != expect for r in ranks):
        raise RuntimeError("main_parallel (d): dp serving disagrees with one process")
    return dict(t2i_s=[r["serve"]["t2i_seconds"] for r in ranks],
                one_process_s=sv["t2i_one_process_seconds"], queue_s=sv["queue_seconds"],
                images=rows)


def _parallel_utilities(state) -> dict:
    """(e) a traced UNet step broken down by summarize_trace, ``checked`` on
    a clean and a NaN-injected UNet call, the allocator's counters."""
    import gc
    import torch
    from vdtpu_torch.serving.api import VDSystem
    from vdtpu_torch.utils.debug import checked
    from vdtpu_torch.utils.profiling import device_memory_stats
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.bfloat16, device="cuda",
                      model_args=_launch_model_args(), with_text_vae=False)
    system.init_random(SEED)
    derandomize_zeros(system.net, SEED + 1)
    ids = stand_in_tokenizer(["", "a red cat sitting on a wooden bench in the sun"])
    u1, c1 = system.ctx_encode(ids[:1], "text"), system.ctx_encode(ids[1:], "text")
    prof = _profile_step(state, system, "main_parallel (e)", u1, c1, images=1)
    x = torch.randn(2, 4, 64, 64, device="cuda", dtype=torch.bfloat16)
    t = torch.full((2,), 500, device="cuda")
    cc = torch.cat([u1, c1])
    call = checked(lambda z: system.model.apply_model(z, t, cc, "image", "text"))
    with torch.no_grad():
        clean = call(x)
        bad = x.clone()
        bad[0, 0, 0, 0] = float("nan")
        try:
            call(bad)
            caught = None
        except FloatingPointError as e:
            caught = str(e)
    mem = device_memory_stats()
    keys = ("allocated_bytes.all.peak", "reserved_bytes.all.current")
    log(f"main_parallel (e) checked: clean UNet call passes ({tuple(clean.shape)}, finite "
        f"{bool(torch.isfinite(clean).all())}), a NaN in the input raises {caught!r}; "
        f"device_memory_stats {[{k: v[k] for k in keys if k in v} for v in mem.values()]} "
        f"[{state.get('card')}]")
    if caught is None or not bool(torch.isfinite(clean).all()) or not mem or prof is None:
        raise RuntimeError("main_parallel (e): checked / device_memory_stats / the trace failed")
    del system, clean
    gc.collect()
    torch.cuda.empty_cache()
    return dict(caught=caught, busy_ms=prof[2], kinds_us=prof[4])


def phase_main_parallel(state):
    """Data and tensor parallelism on the one card: (a)-(b) the launcher under
    torchrun, at once; (c)-(d) the dry run at tp = 2 and dp = 2, at once,
    with (e) the utilities in this process meanwhile."""
    import gc
    import shutil
    import torch
    state.pop("system", None)
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.abspath(PAR_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {}
    # eps_int8's CPU call in a thread of this process meanwhile (4 intra-op
    # threads: the ranks take the other cores)
    job, failed = state.pop("eps_int8_job", None), []
    cpu = None
    if job is not None:
        def run():
            try:
                _eps_int8_cpu(state, job, threads=PAR_CPU_THREADS)
            except BaseException as e:     # re-raised below, after the ranks
                failed.append(e)
        cpu = threading.Thread(target=run, daemon=True)
        cpu.start()
    try:
        res["launcher"] = _parallel_launcher(state, root)
        res["tp"], res["serve"], res["utilities"] = _parallel_dryruns(state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.abspath(LAUNCH_DIR), ignore_errors=True)
        if cpu is not None:
            t = time.perf_counter()
            cpu.join()
            log(f"main_parallel: waited {time.perf_counter() - t:.1f} s for eps_int8's CPU call")
    if failed:
        raise failed[0]
    state["main_parallel"] = res


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
    if "attn_fwd_wg" in n:   # csrc/attn_fwd_sm90.cuh: Mode 2 is NoMax
        return "nomax (hand)" if "mode)2" in n or "modee2" in n else "flash (hand)"
    if "flash_fwd" in n:
        return "flash (hand)"
    if "nomax_fwd" in n:
        return "nomax (hand)"
    if "qconv3" in n:
        return "int8 conv (hand)"
    if "resblock_kernel" in n:
        return "int8 ResBlock (hand)"
    if "gnq_kernel" in n or "gn_stats_group" in n:
        return "gn int8 (hand)"
    if "gn_kernel" in n:
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


def _profile_step(state, system, label, u1, c1, images: int = 2):
    """One CFG UNet step of ``images`` images (batch 2 x images, 64^2
    latent; ``u1`` / ``c1`` the contexts of one image) under torch.profiler:
    logs wall, device busy, idle share and device ms by kind; returns (the
    profiler's device rows, iterations, busy ms, wall s, device us by kind),
    None where the profiler saw no device time."""
    import torch
    sync = torch.cuda.synchronize
    b = 2 * images
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, 4, 64, 64, device="cuda", generator=gen).to(system.dtype)
    tt = torch.full((b,), 500, device="cuda")
    cc = torch.cat([u1.repeat(images, 1, 1), c1.repeat(images, 1, 1)])
    step = lambda: system.model.apply_model(x, tt, cc, "image", "text")
    iters = 5
    from vdtpu_torch.utils.profiling import summarize_trace, trace
    out = os.path.join("build", "profile", re.sub(r"\W+", "_", label))
    with torch.no_grad():
        for _ in range(3):
            step()
        sync()
        with trace(out) as prof:
            t = time.perf_counter()
            for _ in range(iters):
                step()
            sync()
            wall = (time.perf_counter() - t) / iters
    rows = _device_rows(prof)
    busy = sum(_dev_t(e) for e in rows) / iters / 1e3  # ms per step
    n_kernels = sum(e.count for e in rows) / iters
    log(f"profile {label} UNet step (batch {b} = {images} x CFG, 64^2 latent): wall "
        f"{1e3 * wall:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / (1e3 * wall):.3f}, {n_kernels:.0f} kernels/step [{state.get('card')}]")
    if not rows:
        log("profile: the profiler saw no device time")
        return None
    # device us by kind, from the written trace's kernel events
    kinds = {k: 1e3 * ms for k, ms in summarize_trace(out, None, _kernel_kind).items()}
    log(f"  trace {out}/trace.json: device {sum(kinds.values()) / iters / 1e3:.3f} ms/step "
        f"by summarize_trace, {busy:.3f} by the profiler's rows")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  kind {kind}: {us / iters / 1e3:.3f} ms/step ({us / iters / 1e3 / busy:.3f})")
    return rows, iters, busy, wall, kinds


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

    prof = _profile_step(state, system, label, *ctx)
    if prof is None:
        return
    rows, iters, busy, wall, kinds = prof
    qconv = sum(_dev_t(e) for e in rows if "qconv3" in e.key) / iters / 1e3
    rb = sum(_dev_t(e) for e in rows if "resblock_kernel" in e.key) / iters / 1e3
    gnq = sum(_dev_t(e) for e in rows if "gnq_kernel" in e.key) / iters / 1e3
    log(f"profile {label}: device busy {busy:.3f} ms/step, of it the int8 conv (qconv3) "
        f"{qconv:.3f} ms ({qconv / busy:.3f}), the whole int8 ResBlock (resblock_q) "
        f"{rb:.3f} ms ({rb / busy:.3f}), the int8 GN kernels (gn_silu_q, gn_stats) "
        f"{gnq:.3f} ms ({gnq / busy:.3f}) [{state.get('card')}]")
    for e in sorted(rows, key=_dev_t, reverse=True)[:12]:
        log(f"  top {_dev_t(e) / iters / 1e3:.3f} ms/step x{e.count // iters} {e.key[:90]}")
    state.setdefault("profile", {})[label] = dict(wall_ms=1e3 * wall, busy_ms=busy,
                                                  kinds=kinds, resblock_q_ms=rb, gnq_ms=gnq)


def phase_profile(state):
    """Profile the exact path, and int8, int8 + ToMe, int8
    gn_prologue="fused" and int8 conv="fused2" once calibrated."""
    from vdtpu_torch.ops.quant import QuantPolicy
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
    with _policy(system, QuantPolicy(gn_prologue="fused")):
        _profile_mode(state, system, "gn_fused")
    with _policy(system, QuantPolicy(conv="fused2")):
        _profile_mode(state, system, "fused2")


def main() -> int:
    global _LOG
    if "--launch-worker" in sys.argv:    # a rank of main_parallel's launcher runs
        return _launch_worker(sys.argv)
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
    # the port's device timer (this import fails outside a checkout of the repo)
    global time_graph_ms
    from vdtpu_torch.utils.timing import time_graph_ms
    os.makedirs("chiprun_out", exist_ok=True)
    _LOG = open(os.path.join("chiprun_out", "chip_smoke.log"), "w")
    state = {"kernels": {}, "phases": phases}
    try:
        t_all = time.perf_counter()
        for phase in PHASES:
            if phase not in phases:
                continue
            t = time.perf_counter()
            globals()[f"phase_{phase}"](state)
            log(f"phase {phase}: {time.perf_counter() - t:.1f} s")
        warm = state.get("main", {}).get("warm", {}).get("seconds")
        log(f"all phases: {time.perf_counter() - t_all:.1f} s; the main bf16 t2i request warm: "
            f"{'not run' if warm is None else f'{warm:.3f} s'} (the host's pace)")
    finally:
        _LOG.close()
    if {"main", "main_f32", "main_mcg", "main_int8", "modes", "main_fused2", "probes",
            "train", "main_launch"} <= set(phases):
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

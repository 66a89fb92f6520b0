"""The serving-policy quality gate: the port's counterpart of
``scripts/int8_quality.py``.

    python -m vdtpu_torch.quality [--surrogate] [--clip-sweep q99.9,sigma4]
                                  [--device cpu]

How far each approximate serving mode moves a text-to-image request from
the exact bf16 output, on one seeded x_T and one conditioning for every
variant: ``vd_four_flow_v1-0`` in bf16, n = 2, DDIM-50, CFG 7.5, 512^2.

- Conditioning: the CLIP text tower on seeded random token ids; the
  unconditional context on a row of the last id (the EOT id, "" padded);
  each scaled to unit standard deviation, since random CLIP weights
  under-scale the embeddings.
- Weights: CLIP, VAE and vision towers from the port's seeded init. The
  diffusers either all N(0, 0.02), norm scales included (the random-fill
  regime, ``scripts/_common.py::fill_params``), or (``--surrogate``) under
  torch's default layer init (uniform within 1/sqrt(fan_in), unit norms)
  with the reference's zero-initialized layers at zero, then every
  all-zero tensor redrawn from N(0, 0.02), as
  ``tests/_reference.py::derandomize_zeros`` does to the reference modules.
- Calibration: ``VDSystem.calibrate`` over five probes (t in 0, 250, 500,
  750, 999; batch 2n; seeded latents; the [uncond, cond] context) of the
  image / text flow.
- Rows against the exact bf16 run: int8, int8 + encoder reuse 2 and 3
  (warmup 5), int8 + cfg interval (0.1, 0.8), int8 + DPM-Solver++(2M) 20
  steps, the last with encoder reuse 2 (``composed``), int8 + ToMe 0.5 and
  0.75. Each runs on the public sampler API (``DDIMSampler.sample``'s
  ``method``, ``encoder_reuse``, ``cfg_interval``, ``return_intermediates``
  and ``VDSystem.enable_tome``). Per row: final latent cosine and relative
  error, decoded MAE and PSNR over the exact image's range, CLIP-sim
  (``training/evaluator.py::ClipSimilarityEvaluator``: the vision CLS token
  of the images mapped by the exact row's range, the text encoding at each
  prompt's largest id) and its delta against the int8 row.
- ``--clip-sweep``: recalibrate under ``QuantPolicy(clip=mode)`` for "none"
  and each mode, and report the int8 path's divergence per mode instead of
  the ladder.

The JSON result goes to stdout (the script's keys, plus
``bf16_exact_repeat_bit_equal``: the exact row run again after every
other row), the markdown rows to stderr. Runs on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from vdtpu_torch.models.layers import GroupNorm32
from vdtpu_torch.ops.quant import QuantPolicy, quant_state
from vdtpu_torch.serving.api import VDSystem, resolve_device
from vdtpu_torch.training.evaluator import ClipSimilarityEvaluator

TIMESTEPS = (0, 250, 500, 750, 999)
SCALE = 7.5
FILL_STD = 0.02
CFG_BAND = (0.1, 0.8)
DPMPP_STEPS = 20
REUSE_WARMUP = 5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---- the two weight regimes of the diffusers ----

@torch.no_grad()
def fill_normal(module: nn.Module, generator: torch.Generator, std: float = FILL_STD) -> None:
    """Every parameter of ``module`` from N(0, std)."""
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)


@torch.no_grad()
def default_init(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default ``reset_parameters`` of every layer, drawn from
    ``generator``: conv and linear weights and biases uniform within
    +-1/sqrt(fan_in) (kaiming-uniform with a = sqrt(5)), norms at unit
    scale and zero shift."""
    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator, device=p.device) * 2 - 1) * bound)

    for mod in module.modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = mod.weight[0].numel() ** -0.5
            uniform(mod.weight, bound)
            if mod.bias is not None:
                uniform(mod.bias, bound)
        elif isinstance(mod, (GroupNorm32, nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        else:
            raise TypeError(f"no default init for {type(mod).__name__} ({sorted(own)})")


@torch.no_grad()
def derandomize_zeros(module: nn.Module, generator: torch.Generator,
                      std: float = FILL_STD) -> None:
    """Redraw every all-zero parameter from N(0, std)."""
    for p in module.parameters():
        if p.numel() and not bool(p.any()):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)


def build_system(cfg: str = "vd_four_flow_v1-0", dtype=torch.bfloat16, device=None,
                 surrogate: bool = False, seed: int = 0) -> VDSystem:
    """The gate's system: the port's seeded init everywhere, then the
    diffusers in the chosen regime, in f32, cast to ``dtype`` last."""
    system = VDSystem(cfg, dtype=torch.float32, device=resolve_device(device))
    system.init_random(seed)
    gen = torch.Generator(device=system.device).manual_seed(seed + 7)
    diffuser = system.model.diffuser
    if surrogate:
        default_init(diffuser, gen)
        with torch.no_grad():       # the reference's zero_module layers
            for p in diffuser.parameters():
                if getattr(p, "zero_init", False):
                    p.zero_()
        derandomize_zeros(diffuser, gen)
    else:
        fill_normal(diffuser, gen)
    return system.cast(dtype)


# ---- the gate ----

def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def cos(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def divergence(x, img, x_ref, img_ref) -> dict:
    """The script's row metrics of (latent, image) against the exact row's."""
    rng = img_ref.max() - img_ref.min() + 1e-9
    mse = float(((img - img_ref) ** 2).mean())
    return {"final_latent_cos": round(cos(x, x_ref), 5),
            "final_latent_rel_err": round(float(
                np.abs(x - x_ref).mean() / (np.abs(x_ref).mean() + 1e-9)), 5),
            "decoded_mae": round(float(np.abs(img - img_ref).mean()), 5),
            "decoded_psnr_db": round(float(10 * np.log10(rng ** 2 / max(mse, 1e-12))), 2)}


def row_modes(steps: int, composed: bool = True, dpmpp_steps: int = DPMPP_STEPS,
              warmup: int = REUSE_WARMUP):
    """(name, sampler modes, ToMe ratio) of the int8 ladder."""
    reuse = lambda k: {"interval": k, "warmup": warmup}
    rows = [("int8", dict(steps=steps), 0.0),
            ("int8+encreuse2", dict(steps=steps, encoder_reuse=reuse(2)), 0.0),
            ("int8+encreuse3", dict(steps=steps, encoder_reuse=reuse(3)), 0.0),
            ("int8+cfgitv(%g,%g)" % CFG_BAND, dict(steps=steps, cfg_interval=CFG_BAND), 0.0),
            (f"int8+dpmpp{dpmpp_steps}", dict(steps=dpmpp_steps, method="dpmpp2m"), 0.0)]
    if composed:
        rows.append((f"int8+dpmpp{dpmpp_steps}+encreuse2",
                     dict(steps=dpmpp_steps, method="dpmpp2m", encoder_reuse=reuse(2)), 0.0))
    rows += [(f"int8+tome{r}", dict(steps=steps), r) for r in (0.5, 0.75)]
    return rows


class Gate:
    """One system, one conditioning, one x_T; every variant samples and
    decodes through ``observe(name, system, thunk)`` (default: the thunk).
    ToMe merges at the sites of the latent's own map (latent² tokens: 4096
    at 512², the script's ``enable_tome`` default)."""

    def __init__(self, system: VDSystem, n: int, latent: int, seed: int,
                 observe: Callable | None = None):
        self.sys = system
        self.observe = observe or (lambda name, system, thunk: thunk())
        self.tome_min_tokens = latent * latent
        dev = system.device
        enc = system.ctx["text"]
        vocab = enc.text_model.embeddings.token_embedding.num_embeddings
        g = torch.Generator(device=dev).manual_seed(seed + 5)
        self.ids = torch.randint(0, vocab, (n, enc.max_len), generator=g, device=dev)
        unit = lambda e: (e / (e.std(correction=0) + 1e-6)).to(system.dtype)
        self.cond = unit(system.ctx_encode(self.ids, "text").float())
        self.uncond = unit(system.ctx_encode(torch.full_like(self.ids, vocab - 1), "text").float())
        c = dict(system.cfg["args"]["diffuser_cfg_list"])["image"]["args"]["in_channels"]
        g = torch.Generator(device=dev).manual_seed(seed + 42)
        self.xt = torch.randn((n, latent, latent, c), generator=g, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1000)
        ctx = torch.cat([self.uncond, self.cond])
        self.probes = [(torch.randn((2 * n, c, latent, latent), generator=g,
                                    device=dev).to(system.dtype),
                        torch.full((2 * n,), t, device=dev), ctx, "image", "text")
                       for t in TIMESTEPS]

    def calibrate(self, clip: str | None = None) -> QuantPolicy:
        policy = QuantPolicy(clip=clip)
        self.sys.calibrate(self.probes, policy)
        return policy

    @torch.no_grad()
    def sample(self, steps: int, intermediates: bool = False, **modes):
        """(final latent, pred_xt stack or None) on the shared x_T."""
        c_info = {"type": "text", "conditioning": self.cond,
                  "unconditional_conditioning": self.uncond,
                  "unconditional_guidance_scale": SCALE}
        out = self.sys.sampler.sample(None, steps, tuple(self.xt.shape),
                                      {"type": "image", "xt": self.xt}, c_info,
                                      dtype=self.sys.dtype, device=self.sys.device,
                                      return_intermediates=intermediates, **modes)
        return (out[0], out[1]["pred_xt"]) if intermediates else (out, None)

    def row(self, name: str, policy: QuantPolicy | None, steps: int, tome: float = 0.0,
            intermediates: bool = False, **modes):
        """(latent, image, pred_xt) of one variant as f32 numpy."""
        self.sys.set_quant_policy(policy)
        self.sys.enable_tome(tome, self.tome_min_tokens)

        def thunk():
            x, traj = self.sample(steps, intermediates, **modes)
            return x, self.sys.vae_decode(x, "image"), traj

        try:
            t0 = time.perf_counter()
            x, img, traj = self.observe(name, self.sys, thunk)
            log(f"{name} {time.perf_counter() - t0:.1f}s")
        finally:
            self.sys.enable_tome(0)
        return _np(x), _np(img), None if traj is None else _np(traj)

    def clip_sims(self, images: dict, img_ref) -> dict:
        """CLIP-sim of each row's images: the images mapped by the exact
        row's range, the prompts' EOT-pooled text encodings."""
        lo, hi = float(img_ref.min()), float(img_ref.max())
        to_img = lambda ims: torch.from_numpy(ims).to(self.sys.device)
        zt = self.sys.clip_text_features(self.ids).float()
        ev = ClipSimilarityEvaluator(
            lambda ims: self.sys.clip_image_features(
                ((to_img(ims) - lo) / max(hi - lo, 1e-9)).clamp(0.0, 1.0)),
            lambda _texts: zt)
        out = {}
        for name, img in images.items():
            ev.clear()
            ev.add_batch(img, None)
            out[name] = round(ev.summarize()["clip_similarity"], 6)
        return out


def run(system: VDSystem, n: int = 2, steps: int = 50, latent: int = 64, seed: int = 0,
        clip_sweep=(), composed: bool = True, weights: str = "random_fill",
        observe: Callable | None = None, _ladder: dict | None = None) -> dict:
    """The gate (or, with ``clip_sweep``, the calibration sweep) on
    ``system``; returns the JSON result. ``_ladder`` (tests at a few steps)
    overrides ``row_modes``' DPM-Solver++ steps and reuse warmup."""
    gate = Gate(system, n, latent, seed, observe)
    x_ref, img_ref, traj_ref = gate.row("bf16_exact", None, steps, intermediates=True)
    head = {"steps": steps, "batch": n}
    if clip_sweep:
        rows, base = {}, None
        for mode in ["none", *clip_sweep]:
            t0 = time.perf_counter()
            policy = gate.calibrate(None if mode == "none" else mode)
            acts = {k: float(v) for k, v in quant_state(system.model.diffuser).items()
                    if "act_scale" in k}
            base = base or acts
            x_m, img_m, traj_m = gate.row(f"clip={mode}", policy, steps, intermediates=True)
            rows[mode] = {"median_scale_ratio": round(float(np.median(
                [acts[k] / base[k] for k in base])), 4),
                "step1_cos": round(cos(traj_ref[0], traj_m[0]), 6),
                **divergence(x_m, img_m, x_ref, img_ref)}
            log(f"clip={mode} {time.perf_counter() - t0:.1f}s -> {rows[mode]}")
        for mode, r in rows.items():
            log(f"| {mode} | {r['median_scale_ratio']} | {r['step1_cos']} "
                f"| {r['final_latent_cos']} | {r['decoded_mae']} | {r['decoded_psnr_db']} |")
        system.set_quant_policy(None)
        return {"clip_sweep": rows, **head, "weights": weights}

    t0 = time.perf_counter()
    policy = gate.calibrate()
    log(f"calibration {time.perf_counter() - t0:.1f}s")
    variants = {}
    traj_q = None
    for name, modes, tome in row_modes(steps, composed, **(_ladder or {})):
        first = name == "int8"
        x, img, traj = gate.row(name, policy, tome=tome, intermediates=first, **modes)
        traj_q = traj if first else traj_q
        variants[name] = (x, img)
    x_again, _, _ = gate.row("bf16_exact_repeat", None, steps)
    system.set_quant_policy(None)

    sims = gate.clip_sims({"bf16_exact": img_ref, **{k: v[1] for k, v in variants.items()}},
                          img_ref)
    log(f"clip_sim: {sims}")
    out = {**head, "conditioning": "clip_random_ids", "weights": weights, "clip_sim": sims,
           "clip_sim_delta_vs_int8": {k: round(v - sims["int8"], 6) for k, v in sims.items()},
           "bf16_exact_repeat_bit_equal": bool(np.array_equal(x_again, x_ref))}
    step_cos = [cos(traj_ref[s], traj_q[s]) for s in range(steps)]
    step_mse = [float(((traj_ref[s] - traj_q[s]) ** 2).mean()) for s in range(steps)]
    out["int8_step_cos_min"] = min(step_cos)
    out["int8_step_cos"] = [round(c, 5) for c in step_cos[::10]] + [round(step_cos[-1], 5)]
    out["int8_step_mse_max"] = max(step_mse)
    for name, (x, img) in variants.items():
        out[name] = divergence(x, img, x_ref, img_ref)
    for name, m in out.items():
        if isinstance(m, dict) and "final_latent_cos" in m:
            log(f"| {name} | {m['final_latent_cos']} | {m['final_latent_rel_err']} "
                f"| {m['decoded_mae']} | {m['decoded_psnr_db']} | {sims.get(name, '')} "
                f"| {round(sims.get(name, 0) - sims['int8'], 6)} |")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--surrogate", action="store_true",
                    help="torch default-init diffusers (zeros redrawn) instead of the "
                         "N(0, 0.02) fill")
    ap.add_argument("--clip-sweep", default="",
                    help="comma list of calibration statistics (q<p>, sigma<k>): recalibrate "
                         "per mode and report the int8 path's divergence only")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--config", default="vd_four_flow_v1-0")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--latent-downsample", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-composed", action="store_true",
                    help="skip the DPM-Solver++ + encoder reuse row")
    return ap.parse_args(argv)


def main(argv=None, observe: Callable | None = None) -> dict:
    """Build the system, run the gate, print the JSON; returns it.
    ``observe(name, system, thunk)`` wraps each variant's sample + decode."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    system = build_system(args.config, getattr(torch, args.dtype), args.device,
                          args.surrogate, args.seed)
    log(f"system {time.perf_counter() - t0:.1f}s "
        f"({'surrogate' if args.surrogate else 'random fill'} diffusers)")
    try:
        out = run(system, n=args.n, steps=args.steps,
                  latent=args.image_size // args.latent_downsample, seed=args.seed,
                  clip_sweep=[m for m in args.clip_sweep.split(",") if m],
                  composed=not args.no_composed,
                  weights="surrogate_torch_init" if args.surrogate else "random_fill",
                  observe=observe)
    finally:
        dev = system.device
        del system
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

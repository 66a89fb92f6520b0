"""The training launcher (``vdtpu/training/launch.py``), the port's
``main.py``: an experiment config -> ``Experiment`` (run dir, config dump,
code snapshot) -> ``VDSystem`` -> data -> ``Trainer``, with checkpoints,
resume and the eval run.

    python -m vdtpu_torch.training.launch --config vd_laion_t2i [--debug]
    python -m vdtpu_torch.training.launch --config exp.json --device cpu
    python -m vdtpu_torch.training.launch --config exp.json --resume_dir log/<name>/<run>
    python -m vdtpu_torch.training.launch --config exp.json --eval [--resume_dir RUN]

    torchrun --nproc_per_node N -m vdtpu_torch.training.launch --config exp.json

``--config`` is the name of a literal of ``config/experiments.py`` or a
JSON file with its keys (the port reads no YAML); a resumed run reads its
run dir's ``config.json``. The system runs on the card unless ``--device
cpu``. Data: webdataset shards through ``data/webdataset.py``; the frozen
VAE and the context encoder turn each raw batch into latents and context
(``encode_batches``), or, with ``data.cache_latents: N``, the first N
batches are encoded once and the towers freed before the training state
exists (``cached_latent_batches``).

Several processes (torchrun's environment, or ``--multihost``, which
requires it): the process group starts first (``parallel/mesh.py``:
NCCL where each rank of the host has a card of its own, gloo where ranks
share one or on the CPU, ``--dist-backend`` to choose), each rank on
``cuda:(LOCAL_RANK % device_count)``. ``train.tp`` lays the ranks out as
(dp, tp); ``data.batch_size`` is the global batch and must divide by dp x
``gradacc_every``. Each rank reads the shards of its dp index
(``ShardIndex(process_index=dp index, process_count=dp)``, batches of
batch_size / dp), so the ranks of one tp group read the same batches; the
latent cache is built on every rank from its own shards. Rank 0 makes the
run dir and writes the log and the checkpoints; ``--eval`` runs on rank 0
alone while the others wait at a barrier. ``--eval`` scores the run's checkpoint (its EMA
shadow by default) or the pretrained weights and writes
``<run>/<eval_subdir or eval>/summary.yaml``, one ``key: float`` line a
metric, written by hand.

The eval run's sampling (``build_eval``, ``run_eval``): a sample function
takes a batch ``{"caption": [...], "image": NHWC in [0, 1]}``: the captions
through the CLIP tokenizer and ``ctx_encode``, the encoding of "" tiled as
the unconditional context, one DDIM (or DPM-Solver++) run with
classifier-free guidance, ``vae_decode``. CLIP-sim pairs the images with
their token ids (``clip_image_features`` / ``clip_text_features``); FID
compares their CLIP vision features with the batch's own images.

Like the JAX package's launcher, ``encode_batches`` hands the images to
``vae_encode(image, x_type)``, so ``train.x_type: text`` gives pixels to the
Optimus VAE and cannot train a text flow through this CLI; text-flow
training runs through ``make_train_step`` / ``Trainer`` (in both packages).
"""
from __future__ import annotations

import argparse
import functools
import itertools
import math
import os
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from vdtpu_torch.training.evaluator import EvalStage, get_evaluator
from vdtpu_torch.utils.logging import print_log, set_log_file

# the eval: section's keys and vdtpu's defaults
EVAL_DEFAULTS = {"ddim_steps": 50, "scale": 7.5, "latent_size": 64, "latent_dim": 4,
                 "evaluator": "clip_similarity", "sampler": "ddim", "seed": 0,
                 "max_batches": None}


def build_eval(system, tokenizer: Callable, vcfg: Mapping | None = None):
    """(sample_fn, evaluator) of an eval run of ``system`` under the eval
    keys ``vcfg`` (``EVAL_DEFAULTS`` for the missing ones). ``sampler``
    ("ddim" or "dpmpp2m") is the method of ``DDIMSampler.sample``.
    Each batch's x_T [B, s, s, latent_dim] is the next draw of normals from
    one generator seeded with ``seed``, on the system's device (the
    samplers draw nothing else at eta 0)."""
    v = {**EVAL_DEFAULTS, **dict(vcfg or {})}
    steps, scale, method = int(v["ddim_steps"]), float(v["scale"]), v["sampler"]
    s, dim, name = int(v["latent_size"]), int(v["latent_dim"]), v["evaluator"]
    gen = torch.Generator(device=system.device).manual_seed(int(v["seed"]))
    uncond_1 = system.ctx_encode(np.asarray(tokenizer([""])), "text")

    @torch.no_grad()
    def sample_fn(batch):
        ids = np.asarray(tokenizer(list(batch["caption"])))
        c = system.ctx_encode(ids, "text")
        u = uncond_1.repeat(c.shape[0], 1, 1)
        shape = (c.shape[0], s, s, dim)
        xt = torch.randn(shape, generator=gen, device=system.device)
        x = system.sampler.sample(
            gen, steps, shape, {"type": "image", "xt": xt},
            {"type": "text", "conditioning": c, "unconditional_conditioning": u,
             "unconditional_guidance_scale": scale},
            dtype=system.dtype, device=system.device, method=method)
        imgs = system.vae_decode(x, "image")
        return (imgs, ids) if name == "clip_similarity" else (imgs, batch["image"])

    if name == "clip_similarity":
        evaluator = get_evaluator(name, image_embed_fn=system.clip_image_features,
                                  text_embed_fn=system.clip_text_features)
    else:
        evaluator = get_evaluator(name, feature_fn=system.clip_image_features)
    return sample_fn, evaluator


def run_eval(system, tokenizer: Callable, vcfg: Mapping | None,
             batches: Iterable) -> dict[str, float]:
    """Score ``system`` on ``batches`` (at most ``max_batches``) through
    ``EvalStage``; returns the evaluator's summary."""
    sample_fn, evaluator = build_eval(system, tokenizer, vcfg)
    limit = {**EVAL_DEFAULTS, **dict(vcfg or {})}["max_batches"]
    loader = itertools.islice(batches, limit) if limit else batches
    return EvalStage(evaluator, sample_fn)(loader)


def build_dataloader(dcfg: Mapping[str, Any], mesh=None):
    """The shards of the mesh's dp index in batches of batch_size / dp (the
    whole batch without a mesh)."""
    from vdtpu_torch.data.webdataset import ImageTextPipeline, ShardIndex
    dp, index = (1, 0) if mesh is None else (mesh.dp, mesh.dp_index)
    index = ShardIndex.from_dir(dcfg["shards"], process_index=index, process_count=dp,
                                seed=dcfg.get("seed", 0))
    return ImageTextPipeline(index, batch_size=dcfg["batch_size"] // dp,
                             image_size=dcfg.get("image_size", 512),
                             shuffle_buffer=dcfg.get("shuffle_buffer", 1000))


def encode_batches(pipeline: Iterable, system, x_type: str = "image", c_type: str = "text",
                   tokenizer: Callable | None = None, encode_chunk: int | None = None):
    """Raw (image, caption) batches through the frozen VAE and context
    encoder into training batches {"x": latents in the model's layout
    (NCHW), "ctx": context}, as float32 host arrays. ``encode_chunk``
    bounds the encode's activation peak: the raw batch is encoded in slices
    of that many and the results joined (equal to the whole batch).
    Closing the generator closes the pipeline's iterator (its producer
    thread stops)."""
    it = iter(pipeline)
    try:
        for batch in it:
            img = batch["image"]
            n = len(img)
            step = n if not encode_chunk else max(1, min(int(encode_chunk), n))
            xs, cs = [], []
            for i in range(0, n, step):
                sl = slice(i, i + step)
                x = system.vae_encode(img[sl], x_type)
                xs.append((x.permute(0, 3, 1, 2) if x.dim() == 4 else x).float().cpu().numpy())
                if c_type == "text":
                    ids = tokenizer(batch["caption"][sl]) if tokenizer else None
                    c = system.ctx_encode(ids, "text")
                else:
                    c = system.ctx_encode(img[sl], "image")
                cs.append(c.float().cpu().numpy())
            yield {"x": xs[0] if len(xs) == 1 else np.concatenate(xs),
                   "ctx": cs[0] if len(cs) == 1 else np.concatenate(cs)}
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class LatentReplay:
    """The latent cache's batches, forever: epoch e is a permutation of the
    cache drawn from ``numpy.random.default_rng([seed, e])``. Iteration
    starts at ``start_step`` (the step a restored trainer has reached): at
    epoch start_step // len(cache), that far into it, so a resumed run
    trains on the batches the uninterrupted run would have taken."""

    def __init__(self, cache: list, seed: int = 0):
        self.cache = cache
        self.seed = seed
        self.start_step = 0

    def order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng([self.seed, epoch]).permutation(len(self.cache))

    def __iter__(self):
        n = len(self.cache)
        epoch, pos = divmod(self.start_step, n)
        while True:
            for i in self.order(epoch)[pos:]:
                yield self.cache[i]
            epoch, pos = epoch + 1, 0


def cached_latent_batches(pipeline: Iterable, system, x_type: str = "image",
                          c_type: str = "text", tokenizer: Callable | None = None,
                          encode_chunk: int | None = None, num_batches: int | None = None,
                          seed: int = 0) -> LatentReplay:
    """The latent cache (``data.cache_latents: N``): encode the first
    ``num_batches`` batches once, stop the pipeline (its producer thread
    joins), free the VAEs and context encoders (``VDSystem.free_towers``)
    and replay the cache (``LatentReplay``). Differences from the JAX
    package's: ``num_batches`` must be a positive count (None or 0 would
    encode a cycling pipeline forever there); the pipeline's thread stops
    here (it stays blocked there); the replay order is seeded from the run's
    seed and the epoch, and a resumed run starts at the epoch it reached
    (there every run replays from epoch 0's order)."""
    if num_batches is None or int(num_batches) <= 0:
        raise ValueError(f"data.cache_latents must be a positive batch count, got {num_batches!r}")
    src = encode_batches(pipeline, system, x_type, c_type, tokenizer, encode_chunk)
    try:
        cache = list(itertools.islice(src, int(num_batches)))
    finally:
        src.close()
    if not cache:
        raise RuntimeError("data.cache_latents: the pipeline yielded no batches")
    system.free_towers()
    return LatentReplay(cache, seed)


def build_tokenizer(ecfg: Mapping[str, Any]):
    """The CLIP tokenizer of the config's vocabulary (None without one);
    ``clip_max_length`` caps the token length (77 for the published towers)."""
    if not ecfg.get("clip_vocab"):
        return None
    from vdtpu_torch.data.tokenizers import CLIPTokenizer
    tok = CLIPTokenizer(ecfg["clip_vocab"], ecfg["clip_merges"])
    return functools.partial(tok, max_length=ecfg.get("clip_max_length", 77))


def _yaml_float(v: float) -> str:
    """A float as PyYAML's safe_dump writes it (a '.' before any exponent,
    .nan and .inf)."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    r = repr(float(v)).lower()
    return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r


def write_summary(path: str, summary: Mapping[str, float]) -> None:
    """``summary.yaml`` by hand: one ``key: float`` line a metric, sorted."""
    with open(path, "w") as f:
        for k in sorted(summary):
            f.write(f"{k}: {_yaml_float(float(summary[k]))}\n")


def eval_run(ecfg: Mapping[str, Any], system, exp, args) -> dict[str, float]:
    """The eval-only run: stream the data split, generate from its captions,
    score, write ``<log_dir>/<eval_subdir or eval>/summary.yaml``."""
    vcfg = dict(ecfg.get("eval") or {})
    out_dir = os.path.join(exp.log_dir, args.eval_subdir or "eval")
    os.makedirs(out_dir, exist_ok=True)
    set_log_file(os.path.join(out_dir, "eval.log"))
    try:
        tokenizer = build_tokenizer(ecfg)
        if tokenizer is None:
            raise SystemExit("--eval needs clip_vocab / clip_merges in the config")
        loader = build_dataloader(ecfg["data"])
        it = iter(loader)
        try:
            summary = run_eval(system, tokenizer, vcfg, it)
        finally:
            it.close()
        write_summary(os.path.join(out_dir, "summary.yaml"), summary)
        print_log(f"eval summary written to {out_dir}/summary.yaml")
        return summary
    finally:
        set_log_file(None)


def build_system(ecfg: Mapping[str, Any], args, training: bool):
    """The run's ``VDSystem``: f32 weights (seeded, then the pretrained
    state dict where the config names one, loaded as the reference keys it,
    not strict), the VAEs and context encoders in the compute dtype (bf16
    with ``bf16: true``); for training the diffusers trainable with
    ``train.params_dtype`` master weights (default f32). Returns (system,
    trainable parameters or None)."""
    from vdtpu_torch.serving.api import VDSystem
    t = (ecfg.get("train") or {}) if training else {}
    compute = torch.bfloat16 if ecfg.get("bf16") else torch.float32
    system = VDSystem(ecfg["model"], dtype=torch.float32, device=args.device,
                      use_checkpoint=bool(t.get("use_checkpoint", False)),
                      remat_max_channels=t.get("remat_max_channels"),
                      with_text_vae=bool(ecfg.get("with_text_vae", True)),
                      model_args=ecfg.get("model_args"))
    system.init_random(args.seed or 0)
    if ecfg.get("pretrained"):
        sd = torch.load(ecfg["pretrained"], map_location="cpu", mmap=True, weights_only=True)
        res = system.load_state_dict(sd.get("state_dict", sd), strict=False)
        print_log(f"pretrained {ecfg['pretrained']}: {len(res.missing_keys)} keys missing")
    if not training:
        return system.cast(compute), None
    for towers in (system.net.vae, system.net.ctx):
        towers.to(compute)
    system.dtype = compute
    params = system.for_training(compute, getattr(torch, t.get("params_dtype") or "float32"))
    return system, params


def main(argv=None):
    """Run the launcher; returns the eval summary with ``--eval``, else
    {"trainer", "system", "exp", "batches"} of the finished training run."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True,
                   help="a literal of vdtpu_torch/config/experiments.py or a JSON file")
    p.add_argument("--signature", nargs="*", default=[])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resume_dir", default=None)
    p.add_argument("--resume_weight", default=None,
                   help="checkpoint tag to restore (default: latest)")
    p.add_argument("--eval", action="store_true", help="run the eval stage only")
    p.add_argument("--eval_subdir", default=None)
    p.add_argument("--device", default=None, help="default: the card ('cpu' for the CPU)")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group (torchrun's environment; implied by it)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl where each rank has a card of its own, else gloo")
    args = p.parse_args(argv)
    if args.multihost and "WORLD_SIZE" not in os.environ:
        raise SystemExit("--multihost needs torchrun's environment (RANK, WORLD_SIZE, ...)")
    return _main(args)


def _start_ranks(args):
    """The process group from torchrun's environment (none without it) and
    the rank's device; returns (rank, world)."""
    from vdtpu_torch.parallel.mesh import init_distributed
    device_type = "cpu" if (args.device or "cuda").startswith("cpu") else "cuda"
    rank, world, local = init_distributed(device_type, args.dist_backend)
    if world > 1 or "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        if device_type == "cuda" and args.device is None:
            args.device = f"cuda:{local % torch.cuda.device_count()}"
        print_log(f"distributed: backend {dist.get_backend()}, world {world}, "
                  f"device {args.device or device_type}")
    return rank, world


def _main(args):
    rank, world = _start_ranks(args)

    from vdtpu_torch.config.experiments import load_experiment
    from vdtpu_torch.parallel.mesh import make_mesh
    from vdtpu_torch.training.experiment import Experiment
    from vdtpu_torch.training.harness import Trainer
    from vdtpu_torch.training.optim import get_optimizer
    from vdtpu_torch.training.schedulers import get_scheduler

    if args.resume_dir:
        exp = Experiment.resume(args.resume_dir)
        ecfg = exp.cfg
    else:
        ecfg = load_experiment(args.config)
        exp = Experiment(ecfg, signature=args.signature, debug=args.debug,
                         seed=args.seed).initiate()
    try:
        if args.eval and rank != 0:
            make_mesh().barrier()   # rank 0 runs the eval
            return None
        if args.eval:
            system, _ = build_system(ecfg, args, training=False)
            try:
                tag = system.load_vdtpu_torch_checkpoint(
                    exp.weight_dir, tag=args.resume_weight,
                    use_ema=bool((ecfg.get("eval") or {}).get("use_ema", True)))
                print_log(f"eval: loaded trained checkpoint '{tag}' from {exp.weight_dir}")
            except FileNotFoundError:
                if args.resume_weight is not None:
                    raise SystemExit(f"--resume_weight {args.resume_weight!r} not found "
                                     f"under {exp.weight_dir}")
            summary = eval_run(ecfg, system, exp, args)
            if world > 1:
                make_mesh().barrier()
            return summary

        tcfg = ecfg["train"]
        try:
            mesh = make_mesh(tp=int(tcfg.get("tp", 1)))
        except ValueError as e:   # tp does not divide the world (a world of one)
            raise SystemExit(f"train.tp={tcfg.get('tp')}: {e}") from e
        accum = tcfg.get("gradacc_every", 1)
        bsz = ecfg["data"]["batch_size"]
        if bsz % (mesh.dp * accum):
            raise SystemExit(f"data.batch_size={bsz} must be divisible by dp={mesh.dp} x "
                             f"gradacc_every={accum}")
        if world > 1:
            print_log(f"mesh: dp {mesh.dp} x tp {mesh.tp}")
        system, params = build_system(ecfg, args, training=True)
        x_type, c_type = tcfg.get("x_type", "image"), tcfg.get("c_type", "text")
        tokenizer = build_tokenizer(ecfg)
        pipeline = build_dataloader(ecfg["data"], mesh)
        cache_n = ecfg["data"].get("cache_latents")
        if cache_n is not None:
            # encode now, before the optimizer state exists, then free the towers
            batches = cached_latent_batches(
                pipeline, system, x_type, c_type, tokenizer,
                encode_chunk=ecfg["data"].get("encode_chunk"), num_batches=cache_n,
                seed=args.seed or 0)
        else:
            batches = encode_batches(pipeline, system, x_type, c_type, tokenizer,
                                     encode_chunk=ecfg["data"].get("encode_chunk"))
        opt, set_lr = get_optimizer(tcfg.get("optimizer", "adamw"), params=params,
                                    pg_lrscale=tcfg.get("pg_lrscale"), freeze=tcfg.get("freeze"),
                                    **tcfg.get("optimizer_args", {}))
        sched = get_scheduler(tcfg.get("scheduler"),
                              global_batch_size=tcfg.get("batch_size", 1),
                              gradacc_every=accum)
        trainer = Trainer(system.model, params, opt, set_lr, scheduler=sched,
                          x_type=x_type, c_type=c_type, ema_decay=tcfg.get("ema_decay"),
                          grad_accum=accum, log_every=tcfg.get("log_every", 100),
                          ckpt_every=tcfg.get("ckpt_every"), ckpt_dir=exp.weight_dir,
                          async_ckpt=bool(tcfg.get("async_ckpt", False)),
                          freeze_groups=tuple(tcfg.get("freeze") or ()),
                          donate=bool(tcfg.get("donate", False)),
                          mesh=mesh)
        if args.resume_dir:
            state = trainer.restore(exp.weight_dir, tag=args.resume_weight)
            print_log(f"resumed from {exp.weight_dir} at step {state.step}")
            if isinstance(batches, LatentReplay):
                batches.start_step = state.step
        try:
            trainer.run(batches, num_iters=tcfg["num_iters"], seed=args.seed or 0)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        return {"trainer": trainer, "system": system, "exp": exp, "batches": batches}
    finally:
        set_log_file(None)


if __name__ == "__main__":
    main()
    import torch.distributed as _dist
    if _dist.is_initialized():
        _dist.destroy_process_group()

"""Dry run of data and tensor parallelism over ``torch.distributed``
(``__graft_entry__.py::dryrun_multichip``): N ranks on a free local port,
on the CPU or on the cards (gloo where ranks share a card or run on the
CPU, NCCL where each has a card of its own: ``mesh.pick_backend``), each
running the port's parallel paths and writing what it saw as JSON.

    python -m vdtpu_torch.parallel.dryrun --nproc 4 --tp 2 --device cpu
    python -m vdtpu_torch.parallel.dryrun --nproc 2 --tp 2 --config vd_four_flow_v1-0 \\
        --phases eps --batch 4 --reference

The parent spawns the ranks (``python -m vdtpu_torch.parallel.dryrun
--rank r ...`` with torchrun's environment), waits for them with a
timeout, kills every rank when one fails or hangs, checks that the
replicas of every dp group agree, and exits 0 only if all of that held.
Each rank, on the mesh ``make_mesh(tp)`` over the weights of ``--seed``
(every all-zero tensor filled with small normals) or of ``--weights``:

- ``eps``: one CFG eps call of the image diffuser, the linears sharded
  over tp (``shard_module``), the flash and GN launches counted;
- ``serve``: a t2i request at n = 2 through ``VDInference(mesh=)`` on
  every rank, then a ``BatchingQueue`` at bucket 2 on rank 0 over the
  leader (``lead()``) with the other ranks in ``follow()``;
- ``train``: ``--train-steps`` Trainer steps (AdamW with the vd_laion_t2i
  lr scales and the text data blocks frozen, EMA 0.9999, ``--accum``
  micro-batches) on the global batch ``--batch``, each rank on its rows,
  the parameters and the EMA hashed after every step (``tree_fingerprint``);
- ``checks``: the tp checkpoint restored at tp = 1 and back, the
  ``MetricAccumulator`` mean over ranks, the shards each dp index reads
  (``launch.build_dataloader``), and the run dir every rank sees.

``--inputs`` (a ``torch.save`` dict) hands over the eps inputs (``eps_x``
NCHW, ``eps_t``, ``eps_c``, ``eps_u``), the training batches (``x`` [S, B,
C, H, W], ``ctx``, ``t``, ``noise`` of the global batch) and the serving
requests (``prompt``, ``seed``, ``queue``: [(prompt, seed), ...]); what is
missing is drawn from ``--seed``. ``--reference``: rank 0 also runs the
eps call, the t2i request and the training in one process (tp = 1, dp =
1) and reports the agreement. ``--keep``: rank 0 writes ``out/rank0.pt``
(eps, images, the full parameters and EMA after training, the last
gradients) for comparisons outside.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

PHASES = ("eps", "serve", "train", "checks")
# vdtpu/config/experiments/vd_laion_t2i.yaml's groups
PG_LRSCALE = {"diffuser_image_data": 1.0, "diffuser_image_context": 1.0,
              "diffuser_text_data": 0.5, "diffuser_text_context": 0.5}
FREEZE = ("diffuser_text_data",)
PROMPT = "a red cat on a wooden bench"
QUEUE = (("a blue cup on a table", 3), ("a lamp in the morning light", 4))


def stub_tokenizer(max_len: int, vocab: int):
    """Deterministic CLIP-shaped ids (no vocabulary ships with the repo):
    start vocab - 2, one crc32 id per word, end vocab - 1 padding."""
    def tokenize(texts):
        rows = []
        for t in texts:
            ids = [1 + zlib.crc32(w.encode()) % (vocab - 3) for w in t.split()][:max_len - 2]
            rows.append([vocab - 2] + ids + [vocab - 1] * (max_len - 1 - len(ids)))
        return np.array(rows, np.int64)
    return tokenize


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=os.path.join("build", "dryrun"))
    p.add_argument("--config", default="vd_test_tiny")
    p.add_argument("--model-args", default=None, help="JSON file of model_args")
    p.add_argument("--phases", default=",".join(PHASES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default=None, help="a reference-keyed state dict (.pt)")
    p.add_argument("--inputs", default=None)
    p.add_argument("--dtype", default="float32", help="serving and eps dtype")
    p.add_argument("--compute-dtype", default="float32", help="training compute dtype")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--latent-downsample", type=int, default=2)
    p.add_argument("--steps", type=int, default=2, help="DDIM steps of the requests")
    p.add_argument("--batch", type=int, default=4, help="global batch (eps and training)")
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--train-steps", type=int, default=3)
    p.add_argument("--base-lr", type=float, default=1e-4)
    p.add_argument("--reference", action="store_true")
    p.add_argument("--keep", action="store_true",
                   help="rank 0 writes out/rank0.pt (eps, images, parameters, EMA, gradients)")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole run")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return p


# ---- one rank -------------------------------------------------------------------------

def _derandomize(module, seed: int, std: float = 0.02) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            if p.numel() and not bool(p.any()):
                p.copy_(torch.randn(p.shape, generator=gen).to(p) * std)


def _system(args, device, dtype):
    from vdtpu_torch.serving.api import VDSystem
    model_args = None
    if args.model_args:
        with open(args.model_args) as f:
            model_args = json.load(f)
    system = VDSystem(args.config, dtype=torch.float32, device=device, with_text_vae=False,
                      model_args=model_args, use_checkpoint=False)
    if args.weights:
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        res = system.load_state_dict(sd, strict=False)
        if res.missing_keys:
            raise KeyError(f"--weights lacks {res.missing_keys[:5]}")
    else:
        system.init_random(args.seed)
        _derandomize(system.net, args.seed + 1)
    return system.cast(dtype)


def _inputs(args, system, device):
    """The eps, training and serving inputs: --inputs, else drawn."""
    given = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    gen = torch.Generator().manual_seed(args.seed + 2)
    s = args.image_size // args.latent_downsample
    text = system.ctx["text"]
    tok = stub_tokenizer(text.max_len, text.text_model.embeddings.token_embedding.num_embeddings)
    b = args.batch
    if "eps_x" not in given or "x" not in given:
        with torch.no_grad():
            ctx = system.ctx_encode(tok([f"prompt {i} of the dry run" for i in range(b)]),
                                    "text").float().cpu()
            unc = system.ctx_encode(tok([""] * b), "text").float().cpu()
        given.setdefault("eps_x", torch.randn(b, 4, s, s, generator=gen))
        given.setdefault("eps_t", torch.randint(0, 1000, (b,), generator=gen))
        given.setdefault("eps_c", ctx)
        given.setdefault("eps_u", unc)
        n = args.train_steps
        given.setdefault("x", torch.randn(n, b, 4, s, s, generator=gen))
        given.setdefault("ctx", ctx[None].repeat(n, 1, 1, 1))
        given.setdefault("t", torch.randint(0, 1000, (n, b), generator=gen))
        given.setdefault("noise", torch.randn(n, b, 4, s, s, generator=gen))
    given.setdefault("prompt", PROMPT)
    given.setdefault("seed", args.seed)
    given.setdefault("queue", list(QUEUE))
    return given, tok


def _counts():
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from vdtpu_torch.ops.gn_silu import gn_silu
    return {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches,
            "gn_silu": gn_silu.launches}


def _zero_counts():
    from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from vdtpu_torch.ops.gn_silu import gn_silu
    for c in (flash_attention, flash_attention_bwd, gn_silu):
        c.launches = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agreement(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Cosine, relative L2 and max |a - b|, summed in f64 where a and b lie."""
    a, b = a.flatten().float(), b.flatten().float()
    s = lambda t: float(t.sum(dtype=torch.float64))
    d = a - b
    ab, aa, bb = s(a * b), s(a * a), s(b * b)
    return {"cosine": ab / max((aa * bb) ** 0.5, 1e-300),
            "rel_l2": (s(d * d) / max(bb, 1e-300)) ** 0.5, "max_abs": float(d.abs().max())}


@torch.no_grad()
def _cfg_eps(system, x, t, c, u, scale: float = 7.5):
    """(the model's output for [u; c], the guided eps) in f32."""
    dt = system.dtype
    out = system.model.apply_model(torch.cat([x, x]).to(dt), torch.cat([t, t]),
                                   torch.cat([u, c]).to(dt), "image", "text").float()
    eu, ec = out.chunk(2)
    return out, eu + scale * (ec - eu)


def _phase_eps(args, mesh, system, data, device, res, keep):
    """The eps call through the sharded layers. With ``--reference`` rank 0
    first runs it in one process, in the system's dtype and (for a 16-bit
    one) in f32 on the same weights: guidance multiplies the rounding of
    (cond - uncond) by its scale, so a 16-bit path is held to f32 beside
    the one-process path's own distance to f32."""
    from vdtpu_torch.parallel.mesh import shard_module
    x, t = data["eps_x"].to(device), data["eps_t"].to(device)
    c, u = data["eps_c"].to(device), data["eps_u"].to(device)
    ref = ref32 = None
    if args.reference and mesh.rank == 0:
        ref = _cfg_eps(system, x, t, c, u)
        if system.dtype != torch.float32:
            dt = system.dtype
            ref32 = _cfg_eps(system.cast(torch.float32), x, t, c, u)
            system.cast(dt)
    res["sharded"] = len(shard_module(system.model.diffuser, mesh))
    _sync(device)
    _zero_counts()
    t0 = time.perf_counter()
    raw, eps = _cfg_eps(system, x, t, c, u)
    _sync(device)
    res["eps"] = {"seconds": time.perf_counter() - t0, "launches": _counts(),
                  "finite": bool(torch.isfinite(eps).all()), "shape": list(eps.shape)}
    if ref is not None:
        res["eps"]["vs_one_process"] = _agreement(eps, ref[1])
        res["eps"]["raw_vs_one_process"] = _agreement(raw, ref[0])
    if ref32 is not None:
        res["eps"]["vs_f32"] = _agreement(eps, ref32[1])
        res["eps"]["one_process_vs_f32"] = _agreement(ref[1], ref32[1])
    keep["eps"] = eps.cpu()


def _phase_serve(args, mesh, system, data, tok, device, res, keep):
    from vdtpu_torch.parallel.mesh import tree_fingerprint
    from vdtpu_torch.serving.api import VDInference
    from vdtpu_torch.serving.queue import BatchingQueue
    kw = dict(text_tokenizer=tok, output_dim=(args.image_size, args.image_size),
              ddim_steps=args.steps, n_sample_image=2, latent_downsample=args.latent_downsample)
    vdi = VDInference(system, mesh=mesh, **kw)

    def queue(v):
        with BatchingQueue(v, buckets=(2,), max_wait_ms=5000) as q:
            futs = [q.submit(p, s) for p, s in data["queue"]]
            return torch.stack([f.result() for f in futs])

    cold = None
    if args.reference:   # a cold request first, so the timed ones below are warm
        _sync(device)
        t0 = time.perf_counter()
        vdi.inference_t2i(data["prompt"], data["seed"])
        _sync(device)
        cold = time.perf_counter() - t0
    _sync(device)
    _zero_counts()
    t0 = time.perf_counter()
    imgs = vdi.inference_t2i(data["prompt"], data["seed"])
    _sync(device)
    out = {"t2i_seconds": time.perf_counter() - t0, "t2i_cold_seconds": cold,
           "t2i_hash": tree_fingerprint({"i": imgs}),
           "t2i_shape": list(imgs.shape), "t2i_finite": bool(torch.isfinite(imgs).all()),
           "t2i_launches": _counts()}
    keep["t2i"] = imgs.float().cpu()
    if args.reference and mesh.rank == 0 and mesh.tp == 1:
        one = VDInference(system, **kw)
        t0 = time.perf_counter()
        ref = one.inference_t2i(data["prompt"], data["seed"])
        _sync(device)
        out["t2i_one_process_seconds"] = time.perf_counter() - t0
        out["t2i_vs_one_process"] = [_agreement(imgs[i], ref[i]) for i in range(len(ref))]
        keep["queue_one_process"] = queue(one).float().cpu()
    if mesh.rank == 0:
        t0 = time.perf_counter()
        with vdi.lead():
            rows = queue(vdi)
        _sync(device)
        out["queue_seconds"] = time.perf_counter() - t0
        keep["queue"] = rows.float().cpu()
        out["queue_finite"] = bool(torch.isfinite(keep["queue"]).all())
        if "queue_one_process" in keep:
            out["queue_vs_one_process"] = [
                _agreement(keep["queue"][i], keep["queue_one_process"][i])
                for i in range(len(rows))]
    else:
        out["followed"] = vdi.follow()
    res["serve"] = out


def build_trainer(args, mesh, system, ckpt_dir=None):
    """The dry run's ``Trainer`` over ``system``'s diffusers (f32 master
    weights, ``--compute-dtype``): AdamW (decay 0.01) with the vd_laion_t2i
    lr scales, the text data blocks frozen, EMA 0.9999, ``--accum``
    micro-batches, ``stable_diffusion_linear`` at ``--base-lr``."""
    from vdtpu_torch.training.harness import Trainer
    from vdtpu_torch.training.optim import get_optimizer
    from vdtpu_torch.training.schedulers import get_scheduler
    compute = getattr(torch, args.compute_dtype)
    params = system.for_training(compute, torch.float32)
    opt, set_lr = get_optimizer("adamw", params, PG_LRSCALE, FREEZE, weight_decay=0.01)
    sched = get_scheduler({"type": "stable_diffusion_linear", "base_lr": args.base_lr},
                          global_batch_size=args.batch, gradacc_every=args.accum)
    return Trainer(system.model, params, opt, set_lr, sched, ema_decay=0.9999,
                   grad_accum=args.accum, freeze_groups=FREEZE, log_every=10**9,
                   ckpt_dir=ckpt_dir, mesh=mesh)


def _batches(data, mesh, device):
    from vdtpu_torch.parallel.mesh import batch_rows
    rows = (lambda a: batch_rows(a, mesh)) if mesh is not None else (lambda a: a)
    for i in range(data["x"].shape[0]):
        yield {"x": rows(data["x"][i]).to(device), "ctx": rows(data["ctx"][i]).to(device),
               "t": data["t"][i].to(device), "noise": data["noise"][i].to(device)}


def _last_grads(tr, mesh):
    """The last step's gradients, gathered whole, where they lie."""
    from vdtpu_torch.parallel.mesh import full_tensor
    from vdtpu_torch.training.ema import tree_items
    return {k: full_tensor(p.grad, p, mesh).float() for k, p in tree_items(tr.state.params)
            if p.grad is not None}


def _phase_train(args, mesh, system, data, device, res, keep):
    """The Trainer steps. With ``--reference`` rank 0 then trains a fresh
    system of the same weights in one process and compares the last
    gradients and the parameters (gathered whole; every rank gathers)."""
    from vdtpu_torch.parallel.mesh import full_state_dict, tree_fingerprint
    from vdtpu_torch.training.ema import tree_items
    ckpt = os.path.join(args.out, f"ckpt_dp{mesh.dp}_tp{mesh.tp}")
    tr = build_trainer(args, mesh, system, ckpt if "checks" in args.phases else None)
    log = []

    def after(trainer):
        _sync(device)
        log.append({"loss": trainer.last_loss, "seconds": time.perf_counter() - t0[0],
                    "comm_s": trainer.comm_seconds, "launches": _counts(),
                    "params_hash": tree_fingerprint(trainer.state.params),
                    "ema_hash": tree_fingerprint(trainer.state.ema.shadow)})
        _zero_counts()
        t0[0] = time.perf_counter()

    tr.after_step = after
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    _zero_counts()
    t0 = [time.perf_counter()]
    tr.run(_batches(data, mesh, device), num_iters=data["x"].shape[0], seed=args.seed)
    res["train"] = {"steps": log, "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                                               if device.type == "cuda" else None)}
    if not (args.reference or args.keep):
        return tr
    grads = _last_grads(tr, mesh)
    params = full_state_dict(tr.state.params, mesh)
    if args.keep:
        ema = full_state_dict(tr.state.ema.shadow, mesh, like=dict(tree_items(tr.state.params)))
        if mesh.rank == 0:
            keep["params"] = {k: v.detach().float().cpu() for k, v in params.items()}
            keep["ema"] = {k: v.detach().float().cpu() for k, v in ema.items()}
            keep["grads"] = {k: v.cpu() for k, v in grads.items()}
    if args.reference and mesh.rank == 0:
        one = build_trainer(args, None, _system(args, device, getattr(torch, args.dtype)))
        one.run(_batches(data, None, device), num_iters=data["x"].shape[0], seed=args.seed)
        ref_grads = _last_grads(one, None)
        names = sorted(ref_grads)
        flat = lambda d: torch.cat([d[k].detach().float().flatten() for k in names])
        res["train"]["grads_vs_one_process"] = _agreement(flat(grads), flat(ref_grads))
        res["train"]["params_vs_one_process"] = _agreement(flat(params),
                                                           flat(dict(one.state.params)))
        res["train"]["loss_one_process"] = one.last_loss
    return tr


def _phase_checks(args, mesh, system, tr, res):
    """The checkpoint round trip, the metric mean, the shards and the run dir."""
    from vdtpu_torch.parallel.mesh import Mesh, full_state_dict
    from vdtpu_torch.training.checkpoints import save_checkpoint
    from vdtpu_torch.training.ema import tree_items
    from vdtpu_torch.training.experiment import Experiment
    from vdtpu_torch.training.launch import build_dataloader
    from vdtpu_torch.utils.logging import MetricAccumulator
    out = {}
    if tr is not None:
        ckpt = tr.ckpt_dir
        full = full_state_dict(tr.state.params, mesh)
        if mesh.rank == 0:   # the tp checkpoint at tp = 1, saved again as tp = 1
            one = build_trainer(args, None, _system(args, system.device, torch.float32))
            one.restore(ckpt, "last")
            out["restored_at_tp1"] = all(torch.equal(v, full[k].to(v))
                                         for k, v in tree_items(one.state.params))
            save_checkpoint(ckpt, "tp1", one.state, block=True, mesh=Mesh())
        mesh.barrier()
        again = build_trainer(args, mesh, _system(args, system.device, torch.float32))
        again.restore(ckpt, "tp1")
        live = dict(tree_items(tr.state.params))
        out["restored_back"] = all(torch.equal(v, live[k])
                                   for k, v in tree_items(again.state.params))
        shadow = dict(tree_items(tr.state.ema.shadow))
        out["ema_restored_back"] = all(torch.equal(v, shadow[k])
                                       for k, v in tree_items(again.state.ema.shadow))
        opt_live, opt_back = tr.state.opt_state.state_dict(), again.state.opt_state.state_dict()
        out["opt_restored_back"] = all(
            torch.equal(opt_back["state"][i][k], v) for i, st in opt_live["state"].items()
            for k, v in st.items() if torch.is_tensor(v))
    acc = MetricAccumulator()
    acc.accumulate({"a": mesh.rank + 1.0, "b": 2.0 * mesh.rank}, weight=1.0 + mesh.rank)
    acc.accumulate({"a": 0.5 * mesh.rank}, weight=1.0)
    out["local_means"] = {k: acc.sums[k] / acc.weights[k] for k in acc.sums}
    out["means"] = acc.means()
    shards = os.path.join(args.out, "shards")
    os.makedirs(shards, exist_ok=True)
    for i in range(2 * mesh.size):
        open(os.path.join(shards, f"{i:02d}.tar"), "a").close()
    pipe = build_dataloader({"shards": shards, "batch_size": 4 * mesh.dp, "seed": 0}, mesh)
    out["shards"] = [os.path.basename(f) for f in pipe.index.epoch_shards(0)]
    out["rank_batch"] = pipe.batch_size
    exp = Experiment({"name": "dryrun"}, log_root=os.path.join(args.out, "log"))
    exp.initiate(snapshot_code=False)
    out["run_dir"] = exp.log_dir
    res["checks"] = out


def run_rank(args) -> None:
    from vdtpu_torch.parallel.mesh import init_distributed, make_mesh
    if args.device == "cpu":
        torch.set_num_threads(1)
    rank, world, local = init_distributed(args.device, None, args.timeout)
    import torch.distributed as dist
    mesh = make_mesh(args.tp)
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", local % torch.cuda.device_count()))
    phases = args.phases.split(",")
    res = {"rank": rank, "world": world, "dp": mesh.dp, "tp": mesh.tp,
           "dp_index": mesh.dp_index, "tp_index": mesh.tp_index, "device": str(device),
           "backend": dist.get_backend()}
    keep: dict = {}
    system = _system(args, device, getattr(torch, args.dtype))
    data, tok = _inputs(args, system, device)
    if "eps" in phases:
        _phase_eps(args, mesh, system, data, device, res, keep)
    if "serve" in phases:
        _phase_serve(args, mesh, system, data, tok, device, res, keep)
    tr = None
    if "train" in phases:
        tr = _phase_train(args, mesh, system, data, device, res, keep)
    if "checks" in phases:
        _phase_checks(args, mesh, system, tr, res)
    from vdtpu_torch.parallel.collectives import gather_routes
    res["gather_routes"] = dict(gather_routes)
    if device.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    mesh.barrier()
    if rank == 0 and args.keep:
        torch.save(keep, os.path.join(args.out, "rank0.pt"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, indent=1)
    dist.destroy_process_group()


# ---- the parent -----------------------------------------------------------------------

def check_replicas(results: list[dict]) -> list[str]:
    """Faults: two ranks of one dp group (one tp index) whose parameter or
    EMA hashes differ after a step, or whose t2i images differ."""
    faults = []
    by_tp: dict[int, list[dict]] = {}
    for r in results:
        by_tp.setdefault(r["tp_index"], []).append(r)
    for t, group in by_tp.items():
        for key in ("params_hash", "ema_hash"):
            seqs = [[s[key] for s in r.get("train", {}).get("steps", [])] for r in group]
            if any(s != seqs[0] for s in seqs):
                faults.append(f"tp index {t}: {key} differ across the dp group")
    hashes = {r["serve"]["t2i_hash"] for r in results if "serve" in r}
    if len(hashes) > 1:
        faults.append("t2i images differ across ranks")
    return faults


def launch(args, argv: list[str]) -> int:
    os.makedirs(args.out, exist_ok=True)
    for f in os.listdir(args.out):
        if f.startswith("rank") and f.endswith((".json", ".pt")):
            os.remove(os.path.join(args.out, f))
    port = _free_port()
    procs = []
    for r in range(args.nproc):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.nproc), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(args.nproc), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        if args.device == "cpu":
            env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen([sys.executable, "-m", "vdtpu_torch.parallel.dryrun",
                                       *argv, "--rank", str(r)], env=env))
    deadline = time.monotonic() + args.timeout
    failed = None
    while procs and failed is None:
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                failed = f"rank {i} exited {rc}"
        if all(p.poll() == 0 for p in procs):
            break
        if time.monotonic() > deadline:
            failed = f"timeout after {args.timeout:.0f} s"
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed:
        print(f"dryrun failed: {failed}", file=sys.stderr)
        return 1
    results = []
    for r in range(args.nproc):
        with open(os.path.join(args.out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    faults = check_replicas(results)
    for line in faults:
        print(f"dryrun fault: {line}", file=sys.stderr)
    if faults:
        print("dryrun failed", file=sys.stderr)
        return 1
    r0 = results[0]
    print(f"dryrun ok: {args.nproc} ranks (dp={r0['dp']}, tp={r0['tp']}) on {args.device} over "
          f"{r0['backend']}, phases {args.phases}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.rank is not None:
        run_rank(args)
        return 0
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())

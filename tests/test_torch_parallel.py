"""Data and tensor parallelism, port against the JAX package, on the tiny
config and the CPU.

In process: ``make_mesh``'s layout and refusal against vdtpu's, and
``param_spec`` against vdtpu's ``param_shardings`` on its 8-device CPU
mesh (by name, through the port's state-dict keys).

Spawned: ``python -m vdtpu_torch.parallel.dryrun --device cpu`` at dp = 2,
tp = 2 and dp 2 x tp 2 (the three start together, once for the module),
on the weights of ``tiny_systems_from_port`` and the inputs made here:
vdtpu's own draws of t and noise (``jax.random``, as its step splits them)
for three Trainer steps, the port's x_T draws for the requests. Each run is
held to the port's one-process run in this process and to vdtpu's
single-device step and ``VDInference._sample`` (x_T handed over). A
gradient check against one process also catches a gather whose backward
all-reduces (the mutant run here in two gloo processes). The launcher runs
under ``torch.distributed.run`` at tp = 2.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_i2i import tiny_systems_from_port
from vdtpu.parallel import mesh as jmesh
from vdtpu.serving import api as japi
from vdtpu.training import ema as jema
from vdtpu.training import optim as joptim
from vdtpu.training.harness import make_loss_fn as jax_make_loss_fn
from vdtpu_torch.interop.from_jax import state_dict_from_jax
from vdtpu_torch.parallel import dryrun
from vdtpu_torch.parallel.mesh import Mesh, mesh_layout, param_spec, sharded_names, shard_module
from vdtpu_torch.serving.api import VDInference, VDSystem
from vdtpu_torch.serving.queue import BatchingQueue, request_noise
from vdtpu_torch.training import schedulers
from vdtpu_torch.training.ema import tree_items

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"dp2": (2, 1), "tp2": (2, 2), "dp2tp2": (4, 2)}
B, LAT, STEPS, EPS_LAT = 4, 16, 3, 32      # global batch, training latent, steps, eps latent


# -- in process ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tp", [(8, 2), (8, 1), (6, 3), (8, 3)])
def test_make_mesh_layout_matches_vdtpu(n, tp):
    """Rank r at (r // tp, r % tp), where vdtpu's mesh over the 8 CPU
    devices holds device r; an n that tp does not divide raises on both
    sides."""
    if n % tp:
        with pytest.raises(ValueError):
            jmesh.make_mesh(n, tp=tp)
        with pytest.raises(ValueError, match=f"tp={tp}"):
            mesh_layout(n, tp)
        return
    jm = jmesh.make_mesh(n, tp=tp)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    assert dict(jm.shape) == {"dp": n // tp, "tp": tp}
    np.testing.assert_array_equal(mesh_layout(n, tp), ids)
    for r in range(n):
        m = Mesh(n // tp, tp, r)
        assert (m.dp_index, m.tp_index) == tuple(np.argwhere(ids == r)[0])


def _is_norm(torch_key: str, module_types: dict) -> bool:
    return module_types[torch_key.rsplit(".", 1)[0]] in ("GroupNorm32", "LayerNorm")


def test_param_spec_matches_vdtpu_param_shardings(world):
    """The tiny diffusers at tp = 2: exactly the projection and conv
    weights and biases vdtpu's ``param_shardings`` shards on its 8-device
    CPU mesh (norm scales and biases, which vdtpu also lays out over tp,
    stay replicated in the port)."""
    sh = jmesh.param_shardings(jmesh.make_mesh(8, tp=2), world["jsys"].params["diffuser"])
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    specs = {tuple(getattr(k, "key", str(k)) for k in path): s.spec for path, s in flat}
    shards = {k: np.zeros(1, np.float32) for k, sp in specs.items() if any(sp)}
    jax_sharded = set(state_dict_from_jax(_unflatten(shards), ""))
    pmodel = VDSystem("vd_test_tiny", device="meta").model
    types = {n: type(m).__name__ for n, m in pmodel.diffuser.named_modules()}
    jax_sharded = {k for k in jax_sharded if not _is_norm(k, types)}
    ours = set(sharded_names(pmodel.diffuser, 2))
    assert ours == jax_sharded and len(ours) > 20
    owners = dict(pmodel.diffuser.named_modules())
    for name in ours:
        owner, leaf = name.rsplit(".", 1)
        assert param_spec(owners[owner], leaf, 2) == 0
        assert param_spec(owners[owner], leaf, 1) is None


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def test_shard_module_keeps_every_name_and_takes_the_slice():
    psys = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    full = {k: v.clone() for k, v in psys.model.diffuser.state_dict().items()}
    mesh = Mesh(dp=1, tp=2, rank=1)
    names = shard_module(psys.model.diffuser, mesh)
    sd = psys.model.diffuser.state_dict()
    assert set(sd) == set(full) and set(names) == set(sharded_names(
        VDSystem("vd_test_tiny", device="meta").model.diffuser, 2))
    for k, v in sd.items():
        if k in names:
            n = full[k].shape[0] // 2
            assert torch.equal(v, full[k][n:])
        else:
            assert torch.equal(v, full[k])
    assert shard_module(psys.model.diffuser, mesh) == {}     # sharded once


# -- spawned ------------------------------------------------------------------------------

def _jax_draws(step):
    """vdtpu's t and noise of one step (harness.make_train_step): the step's
    key split per micro-batch, then (t, noise) keys; NHWC noise."""
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), 2)
    ts, ns = [], []
    for r in rngs:
        kt, kn = jax.random.split(r)
        ts.append(np.asarray(jax.random.randint(kt, (B // 2,), 0, 1000)))
        ns.append(np.asarray(jax.random.normal(kn, (B // 2, LAT, LAT, 4), jnp.float32)))
    return np.concatenate(ts), np.concatenate(ns)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The shared weights and inputs, the three dry runs (started together)
    and the one-process references."""
    root = tmp_path_factory.mktemp("parallel")
    jsys, psys, sd = tiny_systems_from_port()
    weights = str(root / "weights.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights)
    text = psys.ctx["text"]
    tok = dryrun.stub_tokenizer(text.max_len,
                                text.text_model.embeddings.token_embedding.num_embeddings)
    rs = np.random.RandomState(5)
    draws = [_jax_draws(i) for i in range(STEPS)]
    x = rs.randn(STEPS, B, LAT, LAT, 4).astype(np.float32)
    ctx = rs.randn(STEPS, B, 16, 96).astype(np.float32)
    with torch.no_grad():
        c = psys.ctx_encode(tok([f"prompt {i}" for i in range(B)]), "text")
        u = psys.ctx_encode(tok([""] * B), "text")
    inputs = {"eps_x": torch.from_numpy(rs.randn(B, 4, EPS_LAT, EPS_LAT).astype(np.float32)),
              "eps_t": torch.tensor([3, 250, 611, 998]), "eps_c": c, "eps_u": u,
              "x": torch.stack([_nchw(a) for a in x]), "ctx": torch.from_numpy(ctx),
              "t": torch.from_numpy(np.stack([d[0] for d in draws])).long(),
              "noise": torch.stack([_nchw(d[1]) for d in draws]),
              "prompt": dryrun.PROMPT, "seed": 11, "queue": list(dryrun.QUEUE)}
    path = str(root / "inputs.pt")
    torch.save(inputs, path)
    procs = {}
    for name, (n, tp) in RUNS.items():
        out = str(root / name)
        cmd = [sys.executable, "-m", "vdtpu_torch.parallel.dryrun", "--nproc", str(n), "--tp",
               str(tp), "--device", "cpu", "--out", out, "--weights", weights, "--inputs",
               path, "--batch", str(B), "--timeout", "300", "--keep"]
        procs[name] = (out, subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True,
                                             env=dict(os.environ, PYTHONPATH=ROOT)))
    ref = _one_process(weights, inputs, tok)
    runs = {}
    for name, (out, p) in procs.items():
        log = p.communicate(timeout=330)[0]
        assert p.returncode == 0, log[-3000:]
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
                 for r in range(RUNS[name][0])]
        runs[name] = (ranks, torch.load(os.path.join(out, "rank0.pt"), weights_only=False))
    return {"jsys": jsys, "inputs": inputs, "x": x, "ctx": ctx, "draws": draws, "tok": tok,
            "ref": ref, "runs": runs, "sd": sd}


def _one_process(weights, inputs, tok):
    """The port's own one-process eps, training and requests, in this process."""
    args = dryrun.parser().parse_args(["--device", "cpu", "--weights", weights,
                                       "--batch", str(B)])
    system = dryrun._system(args, torch.device("cpu"), torch.float32)
    _, eps = dryrun._cfg_eps(system, inputs["eps_x"], inputs["eps_t"], inputs["eps_c"],
                             inputs["eps_u"])
    vdi = VDInference(system, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=2,
                      n_sample_image=2, latent_downsample=2)
    t2i = vdi.inference_t2i(inputs["prompt"], inputs["seed"])
    with BatchingQueue(vdi, buckets=(2,), max_wait_ms=5000) as q:
        futs = [q.submit(p, s) for p, s in inputs["queue"]]
        queue = torch.stack([f.result() for f in futs])
    tr = dryrun.build_trainer(args, None, system)
    losses = []
    tr.after_step = lambda t: losses.append(t.last_loss)
    tr.run(dryrun._batches(inputs, None, torch.device("cpu")), num_iters=STEPS)
    return {"eps": eps, "t2i": t2i, "queue": queue, "losses": losses,
            "params": {k: v.detach().clone() for k, v in tree_items(tr.state.params)},
            "ema": {k: v.clone() for k, v in tree_items(tr.state.ema.shadow)},
            "grads": dryrun._last_grads(tr, None)}


@pytest.fixture(scope="module")
def jax_steps(world):
    """vdtpu's single-device step, three times, on its own draws: the loss
    of each step, the parameters and the EMA after them."""
    jsys = world["jsys"]
    jmodel, jparams = jsys.model, jsys.params["diffuser"]
    vg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, "image", "text",
                                                     freeze_groups=dryrun.FREEZE), has_aux=True))
    tx, set_lr = joptim.get_optimizer("adamw", jparams, dryrun.PG_LRSCALE, dryrun.FREEZE,
                                      weight_decay=0.01)
    jopt, jema_st = tx.init(jparams), jema.ema_init(jparams)
    lr = _lr()
    losses = []

    @jax.jit
    def update(grads, jopt, jparams, jema_st):
        upd, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        return jopt, jparams, jema.ema_update(jema_st, jparams, 0.9999)

    for i in range(STEPS):
        ts, ns = world["draws"][i]
        x, ctx = world["x"][i], world["ctx"][i]
        jopt = set_lr(jopt, lr)
        gsum, lsum = None, 0.0
        for j in range(2):
            sl = slice(j * 2, (j + 1) * 2)
            (l, _), g = vg(jparams, x[sl], ctx[sl], ts[sl], ns[sl])
            gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
            lsum += float(l)
        grads = jax.tree_util.tree_map(lambda a: a / 2, gsum)
        jopt, jparams, jema_st = update(grads, jopt, jparams, jema_st)
        losses.append(lsum / 2)
    by_name = lambda tree: {k[len("diffuser."):]: v
                            for k, v in state_dict_from_jax(tree, "diffuser.").items()}
    return {"losses": losses, "params": by_name(jparams), "ema": by_name(jema_st.shadow),
            "grads": by_name(grads)}


def _lr():
    sched = schedulers.get_scheduler({"type": "stable_diffusion_linear", "base_lr": 1e-4},
                                     global_batch_size=B, gradacc_every=2)
    return sched[0]


def _mean_losses(ranks):
    return [float(np.mean([r["train"]["steps"][i]["loss"] for r in ranks]))
            for i in range(STEPS)]


def _held_in_lr_units(ours, ref, lr, noise_level=()):
    """Every element within 2 * lr * steps, all but 1e-4 of them within
    1e-3 * lr (test_torch_train.py's bounds: Adam moves an element by about
    lr * sign(g), so one whose gradient sits at rounding level may move
    either way; such leaves are held to the first bound only)."""
    far = total = 0
    for name, p in ours.items():
        d = np.abs(np.asarray(p, np.float64) - np.asarray(ref[name], np.float64))
        assert d.max() <= 2 * lr * STEPS, (name, d.max() / lr)
        if name not in noise_level:
            far += int((d > 1e-3 * lr).sum())
            total += d.size
    assert far <= 1e-4 * total, (far, total)


def _noise_level(grads):
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {k for k, g in grads.items() if float(np.abs(g).max()) <= 1e-6 * top}


def _grads_agree(ours, ref, rel=1e-4):
    """Each gradient leaf within ``rel`` of its largest magnitude (or of
    1e-3 of the tree's largest where the leaf's own gradient is at rounding
    level), test_torch_train.py's gradient bound: f32 summation order
    (each rank sums its own rows and micro-batches) moves single elements
    by about 1e-5 of the leaf's largest. A doubled or halved gradient is
    off by 50% or more."""
    assert set(ours) == set(ref)
    top = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g, np.float64)
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), g, rtol=0,
                                   atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("run", list(RUNS))
def test_dryrun_eps_matches_one_process(world, run):
    """The CFG eps call, the linears sharded over tp: within 1e-5 of one
    process (f32, summation order)."""
    ranks, kept = world["runs"][run]
    ref = world["ref"]["eps"]
    assert all(r["eps"]["finite"] for r in ranks)
    assert ranks[0]["sharded"] == (0 if RUNS[run][1] == 1 else
                                   len(sharded_names(VDSystem("vd_test_tiny",
                                                              device="meta").net.diffuser, 2)))
    np.testing.assert_allclose(kept["eps"].numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("run", list(RUNS))
def test_dryrun_training_matches_vdtpu_single_device_step(world, jax_steps, run):
    """Three steps on vdtpu's draws against vdtpu's jitted single-device
    step: the loss (the mean of the ranks' means) within 1e-5 relative; the
    parameters and the EMA in units of lr (test_torch_train.py's bounds)."""
    ranks, kept = world["runs"][run]
    np.testing.assert_allclose(_mean_losses(ranks), jax_steps["losses"], rtol=1e-5)
    noise = _noise_level(jax_steps["grads"])
    for key in ("params", "ema"):
        ours = {k: v.numpy() for k, v in kept[key].items()}
        _held_in_lr_units(ours, jax_steps[key], _lr(), noise)


@pytest.mark.parametrize("run", list(RUNS))
def test_dryrun_training_matches_one_process(world, run):
    """Against the port's one-process run on the same draws: losses within
    1e-5 relative, the last step's gradients leaf by leaf within 1e-4 of
    the leaf's largest (``_grads_agree``), the parameters and EMA in units
    of lr."""
    ranks, kept = world["runs"][run]
    ref = world["ref"]
    np.testing.assert_allclose(_mean_losses(ranks), ref["losses"], rtol=1e-5)
    _grads_agree({k: v.numpy() for k, v in kept["grads"].items()},
                 {k: v.numpy() for k, v in ref["grads"].items()})
    noise = _noise_level({k: v.numpy() for k, v in ref["grads"].items()})
    for key in ("params", "ema"):
        _held_in_lr_units({k: v.numpy() for k, v in kept[key].items()},
                          {k: v.numpy() for k, v in ref[key].items()}, _lr(), noise)


@pytest.mark.parametrize("run", list(RUNS))
def test_replica_hashes_agree_after_every_step(world, run):
    ranks, _ = world["runs"][run]
    assert dryrun.check_replicas(ranks) == []
    for r in ranks:
        assert len(r["train"]["steps"]) == STEPS
    twin = [r for r in ranks if r["tp_index"] == 0]
    assert len(twin) == RUNS[run][0] // RUNS[run][1]
    if RUNS[run][1] == 2:   # tp peers hold different slices
        a, b = ranks[0]["train"]["steps"], ranks[1]["train"]["steps"]
        assert [s["params_hash"] for s in a] != [s["params_hash"] for s in b]


@pytest.mark.parametrize("run", list(RUNS))
def test_checkpoint_restores_at_tp1_and_back(world, run):
    ranks, _ = world["runs"][run]
    assert ranks[0]["checks"]["restored_at_tp1"]
    for r in ranks:
        c = r["checks"]
        assert c["restored_back"] and c["ema_restored_back"] and c["opt_restored_back"]


@pytest.mark.parametrize("run", list(RUNS))
def test_metric_accumulator_means_over_ranks(world, run):
    ranks, _ = world["runs"][run]
    locals_ = [r["checks"]["local_means"] for r in ranks]
    want = {k: float(np.mean([m[k] for m in locals_])) for k in locals_[0]}
    for r in ranks:
        assert r["checks"]["means"] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("run", list(RUNS))
def test_shards_by_dp_index(world, run):
    """Each dp index reads its own shards in batches of batch / dp; the
    ranks of one tp group read the same ones."""
    ranks, _ = world["runs"][run]
    n, tp = RUNS[run]
    by_dp = {}
    for r in ranks:
        by_dp.setdefault(r["dp_index"], []).append(r["checks"]["shards"])
        assert r["checks"]["rank_batch"] == 4
    assert all(all(s == group[0] for s in group) for group in by_dp.values())
    sets = [set(g[0]) for g in by_dp.values()]
    assert len(sets) == n // tp
    assert set.union(*sets) == {f"{i:02d}.tar" for i in range(2 * n)}
    assert sum(len(s) for s in sets) == 2 * n


@pytest.mark.parametrize("run", list(RUNS))
def test_one_run_dir_for_all_ranks(world, run):
    ranks, _ = world["runs"][run]
    dirs = {r["checks"]["run_dir"] for r in ranks}
    assert len(dirs) == 1
    parent = os.path.dirname(dirs.pop())
    assert len(os.listdir(parent)) == 1


@pytest.fixture(scope="module")
def jax_images(world):
    """vdtpu's single-device ``VDInference._sample`` and decode of the four
    rows (the t2i request's two, the queue's two) on the port's x_T."""
    jsys, inputs, tok = world["jsys"], world["inputs"], world["tok"]
    vdi = japi.VDInference(jsys, output_dim=(64, 64), ddim_steps=2, latent_downsample=2,
                           text_latent_dim=96)
    gen = torch.Generator().manual_seed(inputs["seed"])
    xt = [torch.randn((2, 32, 32, 4), generator=gen)]
    xt += [request_noise(s, (32, 32, 4), torch.float32, "cpu")[0] for _, s in inputs["queue"]]
    prompts = [inputs["prompt"]] * 2 + [p for p, _ in inputs["queue"]]
    c = jsys.ctx_encode(tok(prompts), "text")
    u = jsys.ctx_encode(tok([""] * 4), "text")
    z = vdi._sample(jax.random.PRNGKey(0), (4, 32, 32, 4),
                    {"type": "image", "xt": torch.cat(xt).numpy()},
                    {"type": "text", "conditioning": c, "unconditional_conditioning": u,
                     "unconditional_guidance_scale": vdi.scale_textto})
    return np.asarray(jsys.vae_decode(z, "image"))


@pytest.mark.parametrize("run", list(RUNS))
def test_dp_serving_and_queue_match_vdtpu(world, jax_images, run):
    """The t2i request on every rank and the queue at bucket 2 on a leader
    and its followers: within 1e-3 of vdtpu's single-device result (as
    vdtpu holds its own mesh, tests/test_parallel.py) and within 1e-5 of
    the port's one process; every rank returns the whole result."""
    ranks, kept = world["runs"][run]
    ref = world["ref"]
    assert all(r["serve"]["t2i_shape"] == [2, 64, 64, 3] for r in ranks)
    assert all(r["serve"].get("followed", 1) == 1 for r in ranks)   # the bucket's sample
    ours = torch.cat([kept["t2i"], kept["queue"]]).numpy()
    np.testing.assert_allclose(ours, jax_images, atol=1e-3)
    np.testing.assert_allclose(ours, torch.cat([ref["t2i"], ref["queue"]]).numpy(), atol=1e-5)


# -- the gather's backward -----------------------------------------------------------------

_MUTANT = r"""
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, os.environ["ROOT"])
from vdtpu_torch.parallel import collectives
from vdtpu_torch.parallel.mesh import init_distributed, make_mesh, shard_module
torch.set_num_threads(1)
init_distributed("cpu", "gloo")
mesh = make_mesh(2)
if os.environ["MUTANT"] == "1":   # a gather whose backward all-reduces
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.tp_group)
        return g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k), None, None
    collectives._GatherFeatures.backward = staticmethod(backward)
gen = torch.Generator().manual_seed(0)
net = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.SiLU(), torch.nn.Linear(256, 128),
                          torch.nn.SiLU(), torch.nn.Linear(128, 8))
with torch.no_grad():
    for p in net.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
x = torch.randn(4, 64, generator=gen)
full = [p.detach().clone() for p in net.parameters()]
net(x).square().mean().backward()
ref = {n: p.grad.clone() for n, p in net.named_parameters()}
net.zero_grad()
shard_module(net, mesh)
net(x).square().mean().backward()
out = {}
for n, p in net.named_parameters():
    g = p.grad
    if getattr(p, "tp_full_shape", None):
        g = collectives.gather_dim(g, 0, mesh.tp_group)
    out[n] = g
if mesh.rank == 0:
    torch.save({"ref": ref, "tp": out}, os.environ["OUT"])
dist.destroy_process_group()
"""


def _tp2_grads(tmp_path):
    """(one process's gradients, tp = 2's) with the real gather and with the
    mutant, the four processes at once."""
    procs = []
    for mutant in (0, 1):
        env = dict(os.environ, ROOT=ROOT, MUTANT=str(mutant), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dryrun._free_port()),
                   OUT=str(tmp_path / f"grads{mutant}.pt"))
        procs += [subprocess.Popen([sys.executable, "-c", _MUTANT], cwd=ROOT,
                                   env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                   stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0, p.stderr.read()[-2000:]
    return [torch.load(tmp_path / f"grads{m}.pt") for m in (0, 1)]


def test_gather_backward_is_a_slice_and_an_all_reduce_is_caught(tmp_path):
    """tp = 2 gradients of a sharded stack equal one process's; the same
    check fails on a gather whose backward all-reduces (each gradient
    scaled by tp)."""
    good, bad = _tp2_grads(tmp_path)
    _grads_agree({k: v.numpy() for k, v in good["tp"].items()},
                 {k: v.numpy() for k, v in good["ref"].items()})
    with pytest.raises(AssertionError):
        _grads_agree({k: v.numpy() for k, v in bad["tp"].items()},
                     {k: v.numpy() for k, v in bad["ref"].items()})


# -- the launcher under torchrun -------------------------------------------------------------

def test_launcher_under_torchrun_at_tp2(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    vdtpu_torch.training.launch`` at train.tp 2 on the CPU: gloo, one run
    dir, and checkpoints with the keys and full shapes of one process."""
    from test_torch_launch import _workspace
    cfg = _workspace(tmp_path, tp=2, num_iters=2, ckpt_every=None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "vdtpu_torch.training.launch", "--config", cfg, "--device", "cpu",
           "--debug"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "distributed: backend gloo, world 2" in proc.stdout
    assert "mesh: dp 1 x tp 2" in proc.stdout
    runs = os.listdir(tmp_path / "log" / "launch_tiny")
    assert runs == ["999999999999_debug"]
    payload = torch.load(tmp_path / "log" / "launch_tiny" / runs[0] / "weight" / "last.pt",
                         weights_only=True)
    meta = VDSystem("vd_test_tiny", device="meta").model
    shapes = {k: tuple(p.shape) for k, p in meta.named_parameters()}
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == shapes
    assert {k: tuple(v.shape) for k, v in payload["ema"]["shadow"].items()} == shapes
    assert payload["step"] == 2

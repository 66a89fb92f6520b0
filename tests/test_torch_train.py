"""The training slice, port against the JAX package, on the tiny config.

Weights: the port builds ``vd_test_tiny``'s diffusers with its seeded init,
every all-zero tensor is replaced by seeded normals (std 0.02, as
tests/test_torch_slice.py does: a zero output conv makes every gradient
upstream of it zero) and the learned ``logvar`` by seeded values; the same
arrays fill the JAX param tree through ``torch_to_flax`` on the tree's
``jax.eval_shape`` template (no JAX init to compile). The config turns on
``learn_logvar`` and an ``l_elbo_weight``, so every term of ``p_losses``
and the logvar gradient are exercised. Both sides run f32 on the CPU; the
JAX side through ONE module-scoped jitted ``value_and_grad`` of vdtpu's
``make_loss_fn`` at micro-batch 2, which also drives vdtpu's step (its
microbatch split, gradient average, optax update and EMA, in the order of
``make_train_step``; the update and EMA jitted once) with the t and noise
its ``jax.random`` draws give.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vdtpu.config.bank import model_cfg_bank as jax_cfg_bank
from vdtpu.interop.torch_convert import torch_to_flax
from vdtpu.models.vd import VDModel as JVDModel
from vdtpu.ops import schedules as jsched
from vdtpu.training import ema as jema
from vdtpu.training import optim as joptim
from vdtpu.training import schedulers as jschedulers
from vdtpu.training.harness import make_loss_fn as jax_make_loss_fn
from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.interop.from_jax import state_dict_from_jax
from vdtpu_torch.models.layers import init_random
from vdtpu_torch.models.vd import VDModel
from vdtpu_torch.ops import schedules
from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.serving.api import VDSystem
from vdtpu_torch.training import ema, optim, schedulers
from vdtpu_torch.training.checkpoints import latest_tag
from vdtpu_torch.training.harness import TrainState, Trainer, make_loss_fn, make_train_step

torch.set_num_threads(2)

FREEZE = ("diffuser_text_data",)
PG_LRSCALE = {"diffuser_image_data": 1.0, "diffuser_image_context": 1.0,
              "diffuser_text_data": 0.5, "diffuser_text_context": 0.5}
LOSS_ARGS = {"learn_logvar": True, "logvar_init": 0.1, "l_elbo_weight": 0.25}
MB, LAT, CTX = 2, 16, (16, 96)  # micro-batch, latent side, context [L, C]


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    for c in (flash_attention, flash_attention_bwd, gn_silu):
        c.launches = 0
    yield
    assert flash_attention.launches == flash_attention_bwd.launches == gn_silu.launches == 0


def _cfg(bank):
    cfg = copy.deepcopy(bank("vd_test_tiny"))
    cfg["args"].update(LOSS_ARGS)
    return cfg


def _port_model(use_checkpoint=None, seed=0):
    """The port's tiny diffusers + logvar with the fixture's weights."""
    model = VDModel.from_config(_cfg(model_cfg_bank()), use_checkpoint=use_checkpoint)
    init_random(model.diffuser, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(model.diffuser.named_parameters()):
            if not p.any():
                p.copy_(torch.tensor(rs.normal(0, 0.02, tuple(p.shape)).astype(np.float32)))
        model.logvar.copy_(torch.tensor(0.1 + 0.05 * rs.randn(model.logvar.numel())
                                        .astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, jitted value_and_grad, the port's state dict)."""
    jmodel = JVDModel.from_config(_cfg(jax_cfg_bank()))
    template = dict(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)))
    template.pop("logvar")
    pmodel = _port_model()
    sd = {k: v.detach().numpy().copy() for k, v in pmodel.named_parameters()}
    jparams, missing = torch_to_flax({"diffuser." + k: v for k, v in sd.items()}, template,
                                     prefix="diffuser.", strict=True)
    assert not missing
    jparams = jax.tree_util.tree_map(jnp.asarray, dict(jparams, logvar=sd["logvar"]))
    vg = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jmodel, "image", "text", freeze_groups=FREEZE), has_aux=True))
    return jmodel, jparams, vg, sd


def _jax_grads_by_name(grads):
    """A JAX gradient tree -> the port's parameter names."""
    out = {k[len("diffuser."):]: v for k, v in state_dict_from_jax(
        {k: v for k, v in grads.items() if k != "logvar"}, "diffuser.").items()}
    out["logvar"] = np.asarray(grads["logvar"])
    return out


def _inputs(rs, b):
    x = rs.randn(b, LAT, LAT, 4).astype(np.float32)       # NHWC, the JAX layout
    ctx = rs.randn(b, *CTX).astype(np.float32)
    return x, ctx


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


# -- (c) schedule ---------------------------------------------------------------------

@pytest.mark.parametrize("kind,param", [("linear", "eps"), ("cosine", "eps"), ("linear", "x0")])
def test_schedule_tables_match_jax(kind, param):
    """Every table, bit for bit (the same float64 numpy recipe, cast to f32),
    and q_sample within f32 rounding."""
    ours = schedules.DiffusionSchedule.create(1000, kind, 0.00085, 0.012,
                                              parameterization=param)
    ref = jsched.DiffusionSchedule.create(1000, kind, 0.00085, 0.012, parameterization=param)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
              "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert ours.num_timesteps == ref.num_timesteps
    rs = np.random.RandomState(0)
    x, n = rs.randn(3, 4, 5, 5).astype(np.float32), rs.randn(3, 4, 5, 5).astype(np.float32)
    t = np.array([0, 517, 999])
    np.testing.assert_allclose(
        ours.q_sample(torch.tensor(x), torch.tensor(t), torch.tensor(n)).numpy(),
        np.asarray(ref.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(n))),
        rtol=1e-6, atol=1e-6)


# -- (d) loss and gradients -------------------------------------------------------------

def test_p_losses_and_every_gradient_match_jax(tiny):
    """Loss, metrics and every gradient leaf of one micro-batch. Frozen and
    untouched parameters: zero in JAX, no gradient in the port. f32: the
    loss within 1e-5 relative; each gradient leaf within 1e-4 of its own
    largest magnitude, or of 1e-3 of the largest gradient of the tree where
    the leaf's true gradient is zero (a conv bias in front of a one-channel
    GroupNorm group: both sides read rounding noise there). Measured: 1.4e-5
    at worst (summation order through ~40 layers)."""
    _, jparams, vg, _ = tiny
    rs = np.random.RandomState(3)
    x, ctx = _inputs(rs, MB)
    t = np.array([7, 803], np.int32)
    noise = rs.randn(*x.shape).astype(np.float32)
    (jl, jaux), jg = vg(jparams, x, ctx, t, noise)
    model = _port_model()
    loss_fn = make_loss_fn(model, "image", "text", FREEZE)
    loss, aux = loss_fn(_nchw(x), torch.tensor(ctx), torch.tensor(t), _nchw(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    ref = _jax_grads_by_name(jg)
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    frozen = untouched = 0
    top = max(np.abs(r).max() for r in ref.values())
    for name, p in params.items():
        r = ref[name]
        if p.grad is None:
            assert not np.any(r), name
            frozen += optim.parameter_group_of(name) in FREEZE
            untouched += optim.parameter_group_of(name) not in FREEZE
            continue
        scale = max(np.abs(r).max(), 1e-3 * top)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=1e-4 * scale, err_msg=name)
    assert frozen > 0 and untouched > 0  # text data blocks; the image context blocks


def test_training_refuses_serving_policies():
    from vdtpu_torch.ops.quant import QuantPolicy, set_quant_policy
    from vdtpu_torch.ops.tome import ToMeSpec
    model = _port_model()
    model.diffuser.tome = ToMeSpec(0.5, 16)
    with pytest.raises(RuntimeError, match="token merging"):
        make_loss_fn(model, "image", "text")
    model.diffuser.tome = None
    set_quant_policy(model.diffuser, QuantPolicy())
    with pytest.raises(RuntimeError, match="int8"):
        make_loss_fn(model, "image", "text")


# -- (h) remat ----------------------------------------------------------------------

@pytest.mark.parametrize("remat_max_channels", [None, 32])
def test_remat_gives_the_same_gradients(remat_max_channels):
    """torch.utils.checkpoint recomputes the same ops: loss and gradients
    equal bit for bit with and without remat (all blocks, or only the
    32-channel level)."""
    rs = np.random.RandomState(4)
    x, ctx = _inputs(rs, MB)
    t, noise = torch.tensor([3, 600]), _nchw(rs.randn(*x.shape).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = _port_model(use_checkpoint=remat)
        for u in model.diffuser.values():
            u.remat_max_channels = remat_max_channels
        loss, _ = make_loss_fn(model, "image", "text")(_nchw(x), torch.tensor(ctx), t, noise)
        loss.backward()
        grads.append((loss.item(), {k: p.grad for k, p in model.named_parameters()
                                    if p.grad is not None}))
    assert grads[0][0] == grads[1][0]
    assert grads[0][1].keys() == grads[1][1].keys()
    for k, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][k]), k


# -- (e) optimizer, schedulers, EMA -------------------------------------------------------

_OPT_NAMES = ("image.data_blocks_0.w", "image.context_blocks_0.w", "image.time_embed_0.b",
              "text.data_blocks_0.w", "text.context_blocks_0.w", "image.context_blocks_1.w")
_NO_GRAD = "image.context_blocks_1.w"   # a parameter the flow never touches


def _tree(flat):
    tree = {}
    for name, v in flat.items():
        a, b, c = name.split(".")
        tree.setdefault(a, {}).setdefault(b, {})[c] = v
    return tree


@pytest.mark.parametrize("kind,kw", [("adamw", {"weight_decay": 0.01}),
                                     ("adamw", {"weight_decay": 0.01, "mu_dtype": "bfloat16"}),
                                     ("adam", {}),
                                     ("sgd", {"momentum": 0.9, "nesterov": True})])
def test_optimizer_matches_optax(kind, kw):
    """Three updates with pg_lrscale, a frozen group and a parameter that
    never gets a gradient, against vdtpu's optax chain on the same
    gradients. f32: every parameter within one f32 ulp of its value plus
    1e-5 * lr of optax's (bias corrections in f32 on both sides; the rest
    is the rounding of p - lr * u and of the moments)."""
    rs = np.random.RandomState(5)
    flat = {n: rs.randn(3, 4).astype(np.float32) for n in _OPT_NAMES}
    params = {n: torch.tensor(v, requires_grad=True) for n, v in flat.items()}
    opt, set_lr = optim.get_optimizer(kind, params, PG_LRSCALE, FREEZE, **kw)
    jtree = jax.tree_util.tree_map(jnp.asarray, _tree(flat))
    tx, jset_lr = joptim.get_optimizer(kind, jtree, PG_LRSCALE, FREEZE, **kw)
    jstate = tx.init(jtree)
    for step, lr in enumerate((1e-2, 5e-3, 2e-2)):
        grads = {n: rs.randn(3, 4).astype(np.float32) for n in _OPT_NAMES}
        grads[_NO_GRAD] = np.zeros((3, 4), np.float32)
        for n, p in params.items():
            p.grad = None if n == _NO_GRAD else torch.tensor(grads[n])
        set_lr(opt, lr)
        opt.step()
        jstate = jset_lr(jstate, lr)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(grads)), jstate, jtree)
        jtree = optax.apply_updates(jtree, upd)
        for n, p in params.items():
            a, b, c = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jtree[a][b][c]),
                                       rtol=1.2e-7, atol=1e-5 * lr, err_msg=f"step {step} {n}")
    assert torch.equal(params["text.data_blocks_0.w"], torch.tensor(flat["text.data_blocks_0.w"]))
    assert not torch.equal(params[_NO_GRAD], torch.tensor(flat[_NO_GRAD])) or kind != "adamw"
    state_params = {id(p) for p in opt.state}
    assert id(params["text.data_blocks_0.w"]) not in state_params
    if kw.get("mu_dtype"):
        assert all(st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == torch.float32
                   for st in opt.state.values())


def test_schedulers_match_jax():
    pairs = [
        ({"type": "constant", "lr": 0.1, "num_itr": 10}, {}),
        ({"type": "poly", "start_lr": 1.0, "end_lr": 0.1, "num_itr": 11, "power": 2.0}, {}),
        ({"type": "linear", "start_lr": 1.0, "end_lr": 0.0, "num_itr": 7}, {}),
        ({"type": "multistage", "start_lr": 1.0, "milestones": [3, 8], "gamma": 0.1,
          "num_itr": 10}, {}),
        ({"type": "ldm_warmup_cosine", "base_lr": 2.0, "warm_up_steps": 5, "lr_min": 0.1,
          "lr_max": 1.0, "lr_start": 0.0, "max_decay_steps": 30}, {}),
        ({"type": "stable_diffusion_linear", "base_lr": 1e-7},
         {"global_batch_size": 8, "gradacc_every": 2}),
    ]
    for cfg, ctx in pairs:
        ours, ref = schedulers.get_scheduler(cfg, **ctx), jschedulers.get_scheduler(cfg, **ctx)
        assert ours.step_num == ref.step_num
        for i in (0, 1, 3, 5, 9, 29, 40):
            assert ours[i] == ref[i], (cfg["type"], i)
    seq = schedulers.SequentialScheduler([schedulers.ConstantScheduler(0.1, 4),
                                          schedulers.PolyScheduler(1.0, 0.0, 5)])
    jseq = jschedulers.SequentialScheduler([jschedulers.ConstantScheduler(0.1, 4),
                                            jschedulers.PolyScheduler(1.0, 0.0, 5)])
    assert [seq[i] for i in range(12)] == [jseq[i] for i in range(12)]
    pg = schedulers.with_pg_lrscale(seq, PG_LRSCALE)
    jpg = jschedulers.with_pg_lrscale(jseq, PG_LRSCALE)
    assert {g: f(6) for g, f in pg.items()} == {g: f(6) for g, f in jpg.items()}
    assert schedulers.get_scheduler(None) is None


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    """Twelve updates through the warmup decay (n / (10 + n) below 0.99):
    equal to vdtpu's within one f32 ulp of the values."""
    rs = np.random.RandomState(6)
    flat = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    st = ema.ema_init({k: torch.tensor(v) for k, v in flat.items()}, use_num_updates)
    jst = jema.ema_init({k: jnp.asarray(v) for k, v in flat.items()}, use_num_updates)
    for _ in range(12):
        flat = {k: v + rs.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
        ema.ema_update(st, {k: torch.tensor(v) for k, v in flat.items()}, 0.99)
        jst = jema.ema_update(jst, {k: jnp.asarray(v) for k, v in flat.items()}, 0.99)
        assert st.num_updates == int(jst.num_updates)
        for k in flat:
            np.testing.assert_allclose(ema.ema_params(st)[k].numpy(), np.asarray(jst.shadow[k]),
                                       rtol=2.4e-7, atol=2.4e-7)


# -- (f) the slice: three steps at grad_accum 2 ---------------------------------------------

def _jax_draws(step, x_shape):
    """vdtpu's t and noise of one step: fold_in(PRNGKey(0), step), split per
    micro-batch, then (t, noise) keys (harness.make_train_step)."""
    nT = 1000
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), 2)
    ts, ns = [], []
    for r in rngs:
        kt, kn = jax.random.split(r)
        ts.append(np.asarray(jax.random.randint(kt, (x_shape[0] // 2,), 0, nT)))
        ns.append(np.asarray(jax.random.normal(kn, (x_shape[0] // 2,) + x_shape[1:],
                                               jnp.float32)))
    return ts, ns


def test_train_steps_match_jax(tiny):
    """Three steps of the t2i slice (global batch 4, grad_accum 2, AdamW
    with pg_lrscale and the frozen text data blocks, EMA 0.9999, lr from
    ``stable_diffusion_linear``) against vdtpu's step on vdtpu's own draws.
    Loss per step within 1e-5 relative. Parameters and EMA, in units of
    lr: every element within 2 * lr * steps of vdtpu's, and all but 1e-4 of
    the elements within 1e-3 * lr. Adam's update is about lr * sign(g)
    early on, so an element whose gradient sits at rounding level may move
    either way on either side. Whole leaves do that in this config: those
    whose exact gradient is zero (every per-channel parameter in front of
    a GroupNorm group of one channel, at the 32-channel level), about 1e-8
    of the largest gradient on both sides; they are held to the first
    bound only."""
    jmodel, jparams, vg, _ = tiny
    base_lr, steps = 1e-4, 3
    sched = schedulers.get_scheduler({"type": "stable_diffusion_linear", "base_lr": base_lr},
                                     global_batch_size=2 * MB, gradacc_every=2)
    lr = sched[0]
    model = _port_model()
    params = dict(model.named_parameters())
    opt, set_lr = optim.get_optimizer("adamw", params, PG_LRSCALE, FREEZE, weight_decay=0.01)
    step = make_train_step(model, opt, "image", "text", ema_decay=0.9999, grad_accum=2,
                           freeze_groups=FREEZE)
    state = TrainState(params, opt, ema.ema_init(params), 0)

    tx, jset_lr = joptim.get_optimizer("adamw", jparams, PG_LRSCALE, FREEZE, weight_decay=0.01)
    jopt, jema_st = tx.init(jparams), jema.ema_init(jparams)

    @jax.jit
    def jax_update(gsum, jopt, jparams, jema_st):
        grads = jax.tree_util.tree_map(lambda a: a / 2, gsum)
        upd, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        return grads, jopt, jparams, jema.ema_update(jema_st, jparams, 0.9999)

    rs = np.random.RandomState(7)
    noise_level = None
    for i in range(steps):
        x, ctx = _inputs(rs, 2 * MB)
        ts, ns = _jax_draws(i, x.shape)
        # vdtpu's step body: scan over micro-batches, sum, / grad_accum, update, EMA
        jopt = jset_lr(jopt, lr)
        gsum, lsum = None, 0.0
        for j in range(2):
            sl = slice(j * MB, (j + 1) * MB)
            (l, _), g = vg(jparams, x[sl], ctx[sl], ts[j], ns[j])
            gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
            lsum = lsum + l
        grads, jopt, jparams, jema_st = jax_update(gsum, jopt, jparams, jema_st)
        if noise_level is None:
            named = _jax_grads_by_name(grads)
            top = max(np.abs(a).max() for a in named.values())
            noise_level = {k for k, a in named.items() if 0 < np.abs(a).max() <= 1e-6 * top}

        set_lr(opt, lr)
        loss, _ = step(state, _nchw(x), torch.tensor(ctx), torch.tensor(np.concatenate(ts)),
                       _nchw(np.concatenate(ns)))
        np.testing.assert_allclose(loss.item(), float(lsum / 2), rtol=1e-5, err_msg=f"step {i}")
    assert state.ema.num_updates == steps == int(jema_st.num_updates)
    assert 0 < len(noise_level) < 40
    tol, fine = 2 * lr * steps, 1e-3 * lr
    for label, ours, ref in (("params", params, _jax_grads_by_name(jparams)),
                             ("ema", state.ema.shadow, _jax_grads_by_name(jema_st.shadow))):
        far = total = 0
        for name, p in ours.items():
            d = np.abs(p.detach().numpy() - ref[name])
            assert d.max() <= tol, (label, name, d.max() / lr)
            if name not in noise_level:
                far += int((d > fine).sum())
                total += d.size
        assert far <= 1e-4 * total, (label, far, total)
    frozen = [n for n in params if optim.parameter_group_of(n) in FREEZE]
    assert frozen and all(np.array_equal(params[n].detach().numpy(), tiny[3][n])
                          for n in frozen)


def test_grad_accum_averages_the_micro_batch_gradients():
    """Adam barely sees a gradient's scale, so the average is checked with
    SGD at lr 1: one step at grad_accum 2 moves every parameter as one step
    over the whole batch (the mean loss of equal micro-batches is the batch
    mean): within 1e-6 of each leaf's largest move plus one f32 ulp of the
    parameter (summation order, and the rounding of p - g)."""
    rs = np.random.RandomState(9)
    x, ctx = _inputs(rs, 2 * MB)
    t, noise = torch.tensor([5, 250, 500, 990]), _nchw(rs.randn(*x.shape).astype(np.float32))
    runs = []
    for accum in (1, 2):
        model = _port_model()
        params = dict(model.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        opt, set_lr = optim.get_optimizer("sgd", params, freeze=FREEZE)
        set_lr(opt, 1.0)
        step = make_train_step(model, opt, grad_accum=accum, freeze_groups=FREEZE)
        step(TrainState(params, opt, None), _nchw(x), torch.tensor(ctx), t, noise)
        runs.append({k: p.detach() for k, p in params.items()})
    moved = 0
    for k, p1 in runs[0].items():
        scale = float((p1 - before[k]).abs().max())
        moved += scale > 0
        torch.testing.assert_close(runs[1][k], p1, rtol=1.2e-7, atol=1e-6 * scale)
    assert moved > 100


# -- (g) the Trainer: checkpoint, restore, resume ---------------------------------------------

def _trainer(tmp, **kw):
    system = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    params = system.for_training(torch.float32)
    opt, set_lr = optim.get_optimizer("adamw", params, PG_LRSCALE, FREEZE, weight_decay=0.01,
                                      mu_dtype="bfloat16")
    sched = schedulers.get_scheduler({"type": "stable_diffusion_linear", "base_lr": 1e-4},
                                     global_batch_size=4, gradacc_every=2)
    return Trainer(system.model, params, opt, set_lr, sched, ema_decay=0.99, grad_accum=2,
                   ckpt_dir=str(tmp), freeze_groups=FREEZE, log_every=2, **kw)


def test_trainer_checkpoint_restore_resume(tmp_path):
    """Four steps straight against two steps, a checkpoint, a fresh system
    restored from it and two more steps on the same batches: every
    parameter, EMA tensor, optimizer moment and the loss equal bit for bit
    (t and noise come from (seed, step), the optimizer state and the EMA
    count are in the checkpoint). Also the eval-driven best keep and the
    step units."""
    rs = np.random.RandomState(8)
    batches = [{"x": rs.randn(4, 4, 8, 8).astype(np.float32),
                "ctx": rs.randn(4, 16, 96).astype(np.float32)} for _ in range(4)]
    metrics = iter([3.0, 1.0])
    straight = _trainer(tmp_path / "a", eval_fn=lambda st: next(metrics), eval_every=2)
    straight.run(batches, num_iters=4, seed=11)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["best.pt", "last.pt"]
    assert straight.best_metric == 1.0

    first = _trainer(tmp_path / "b", ckpt_every=2)
    first.run(batches[:2], unit="sample", num_units=8, batch_size=4, seed=11)
    assert first.state.step == 2 and latest_tag(str(tmp_path / "b")) == "last"
    resumed = _trainer(tmp_path / "b")
    resumed.restore()
    assert resumed.state.step == 2 and resumed.state.ema.num_updates == 2
    resumed.run(batches[2:], unit="epoch", num_units=2, batches_per_epoch=2, seed=11)
    assert resumed.last_loss == straight.last_loss
    a, b = straight.state, resumed.state
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.ema.shadow[k], b.ema.shadow[k]), k
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert [g["count"] for g in sa["param_groups"]] == [g["count"] for g in sb["param_groups"]]
    for i, st in sa["state"].items():
        assert st["mu"].dtype == torch.bfloat16
        assert torch.equal(st["mu"], sb["state"][i]["mu"]) and torch.equal(st["nu"],
                                                                           sb["state"][i]["nu"])
    frozen = [k for k in a.params if optim.parameter_group_of(k) in FREEZE]
    fresh = _trainer(tmp_path / "c").state.params
    assert frozen and all(torch.equal(a.params[k], fresh[k]) for k in frozen)
    moved = [k for k, p in a.params.items() if p.grad is not None]
    assert moved and all(not torch.equal(a.params[k], fresh[k]) for k in moved)

"""Training, the rest: text-flow steps, the trainable context encoder, bf16
master weights and async checkpoints, port against the JAX package on the
tiny config (weights shared through ``test_torch_i2i.tiny_systems_from_port``;
every all-zero tensor drawn from N(0, 0.02)).

- the text flow (``x_type="text"``, ``c_type`` "text" and "image"): loss,
  every gradient and the parameters after two steps against vdtpu's jitted
  ``make_train_step`` on vdtpu's draws, with the tolerances of
  ``test_torch_train.py``;
- the trainable CLIP text tower (``ctx_encode_fn``): loss and every
  gradient of the ``{"diffuser", "ctx"}`` tree against vdtpu's;
- bf16 master weights: AdamW's parameters and moments and the EMA shadow
  bit-equal to optax's jitted update and vdtpu's ``ema_update``;
- async saves equal to sync saves, a snapshot taken before the next step
  moves every tensor, a restore that waits for a save in flight.
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_i2i import tiny_systems_from_port
from vdtpu.training import ema as jema
from vdtpu.training import optim as joptim
from vdtpu.training.harness import make_loss_fn as jax_make_loss_fn
from vdtpu_torch.interop.from_jax import state_dict_from_jax
from vdtpu_torch.ops.flash import flash_attention, flash_attention_bwd
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.training import checkpoints, ema, optim
from vdtpu_torch.training.ema import tree_items
from vdtpu_torch.training.harness import TrainState, Trainer, make_loss_fn, make_train_step

torch.set_num_threads(2)

LR, STEPS, B = 1e-4, 2, 4
FREEZE = ("diffuser_text_data",)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    for c in (flash_attention, flash_attention_bwd, gn_silu):
        c.launches = 0
    yield
    assert flash_attention.launches == flash_attention_bwd.launches == gn_silu.launches == 0


@pytest.fixture(scope="module")
def shared():
    return tiny_systems_from_port()


@pytest.fixture(scope="module")
def jax_adamw(shared):
    """vdtpu's AdamW (decay 0.01) over the diffuser tree, with its optax
    update and EMA jitted once for the module (both text-flow cases run the
    same update on the same tree)."""
    jparams = shared[0].params["diffuser"]
    tx, jset_lr = joptim.get_optimizer("adamw", jparams, weight_decay=0.01)

    @jax.jit
    def jax_update(g, jopt, jp, jema_st):
        upd, jopt = tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        return jopt, jp, jema.ema_update(jema_st, jp, 0.9999)
    return tx, jset_lr, jax_update


def _port_system(sd):
    from vdtpu_torch.serving.api import VDSystem
    psys = VDSystem("vd_test_tiny", device="cpu")
    psys.load_state_dict(sd, strict=True)
    return psys


def _by_name(tree, prefix="diffuser."):
    flat = {k: v for k, v in tree.items() if k != "logvar"}
    out = {k[len(prefix):]: v for k, v in state_dict_from_jax(flat, prefix).items()}
    if "logvar" in tree:
        out["logvar"] = np.asarray(tree["logvar"])
    return out


def _ctx_shape(c_type):
    return (16, 96) if c_type == "text" else (17, 96)


def _draws(i, x_shape):
    """vdtpu's t and noise at step i, grad_accum 1: fold_in(PRNGKey(0), i),
    then its (t, noise) keys."""
    kt, kn = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i))
    t = jax.random.randint(kt, (x_shape[0],), 0, 1000)
    return np.asarray(t), np.asarray(jax.random.normal(kn, x_shape, jnp.float32))


def _grads_close(params, ref):
    """Every gradient leaf within 1e-4 of its own largest magnitude (or of
    1e-3 of the tree's largest where the leaf's gradient is ~0), as
    ``test_torch_train.py`` holds them; returns, by leaf, the elements whose
    gradient lies inside that band (its sign is not determined by the
    comparison, so Adam's normalized update may go either way there)."""
    top = max(np.abs(r).max() for r in ref.values())
    loose = {}
    for name, p in params.items():
        r = np.asarray(ref[name])
        if p.grad is None:
            assert not np.any(r), name
            continue
        scale = max(np.abs(r).max(), 1e-3 * top)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=1e-4 * scale, err_msg=name)
        loose[name] = np.abs(r) <= 1e-4 * scale
    return loose


@pytest.mark.parametrize("c_type", ["text", "image"])
def test_text_flow_steps_match_jax(shared, jax_adamw, c_type):
    """x_type "text" (the 0-D diffuser's data blocks, [B, 96] latents):
    one gradient, then two AdamW + EMA steps (vdtpu's step body: its
    jitted value_and_grad, optax update and EMA on its own draws). Loss within 1e-5 relative;
    every gradient as ``_grads_close``; parameters and EMA within 2 * lr *
    steps of vdtpu's, all but 1e-4 of the elements within 1e-3 * lr; the
    elements whose first gradient lies inside the gradient band, or whose
    second gradients (at the two sides' own parameters) differ by more than
    1e-3 of their size, are held to the first bound only: Adam's normalized
    update of such an element is not pinned by the comparison."""
    jsys, _, sd = shared
    jparams = jsys.params["diffuser"]
    rs = np.random.RandomState(11)
    xs = [rs.randn(B, 96).astype(np.float32) for _ in range(STEPS)]
    cs = [rs.randn(B, *_ctx_shape(c_type)).astype(np.float32) for _ in range(STEPS)]

    vg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jsys.model, "text", c_type), has_aux=True))
    t0, n0 = _draws(0, xs[0].shape)
    (jl, _), jg = vg(jparams, xs[0], cs[0], t0, n0)
    psys = _port_system(sd)
    params = psys.for_training(torch.float32)
    loss, _ = make_loss_fn(psys.model, "text", c_type)(
        torch.tensor(xs[0]), torch.tensor(cs[0]), torch.tensor(t0), torch.tensor(n0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    loose = _grads_close(params, _by_name(jg))
    assert not any(k.startswith("image.data_blocks") and params[k].grad is not None
                   for k in params)
    for p in params.values():
        p.grad = None

    # vdtpu's step body (make_train_step at grad_accum 1): its loss and
    # gradients from the jitted value_and_grad on its own draws, then the
    # optax update and the EMA, jitted once for the module
    tx, jset_lr, jax_update = jax_adamw
    jopt, jema_st = jset_lr(tx.init(jparams), LR), jema.ema_init(jparams)

    opt, set_lr = optim.get_optimizer("adamw", params, weight_decay=0.01)
    step = make_train_step(psys.model, opt, "text", c_type, ema_decay=0.9999)
    state = TrainState(params, opt, ema.ema_init(params), 0)
    jp = jparams
    for i in range(STEPS):
        t, n = _draws(i, xs[i].shape)
        (jloss, _), jg = vg(jp, xs[i], cs[i], t, n)
        if i:   # after a step the two sides' parameters differ: so do the gradients
            ref = _by_name(jg)
            make_loss_fn(psys.model, "text", c_type)(
                torch.tensor(xs[i]), torch.tensor(cs[i]), torch.tensor(t),
                torch.tensor(n))[0].backward()
            for name in loose:
                r = np.asarray(ref[name])
                loose[name] |= np.abs(params[name].grad.numpy() - r) > 1e-3 * np.abs(r)
                params[name].grad = None
        jopt, jp, jema_st = jax_update(jg, jopt, jp, jema_st)
        set_lr(opt, LR)
        loss, _ = step(state, torch.tensor(xs[i]), torch.tensor(cs[i]), torch.tensor(t),
                       torch.tensor(n))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    tol, fine = 2 * LR * STEPS, 1e-3 * LR
    for label, ours, ref in (("params", params, _by_name(jp)),
                             ("ema", state.ema.shadow, _by_name(jema_st.shadow))):
        far = total = 0
        for name, p in ours.items():
            d = np.abs(p.detach().numpy() - np.asarray(ref[name]))
            assert d.max() <= tol, (label, name, d.max() / LR)
            held = ~loose[name] if name in loose else np.ones(d.shape, bool)
            far += int((d[held] > fine).sum())
            total += d.size
        assert far <= 1e-4 * total, (label, far, total)


def test_trainable_context_encoder_matches_jax(shared):
    """The CLIP text tower inside the loss (``ctx_encode_fn``) on raw token
    ids, the ``{"diffuser", "ctx"}`` tree, the text data blocks frozen:
    loss within 1e-5 relative, every diffuser and context-encoder gradient
    as ``_grads_close``; then two Trainer steps move the tower."""
    jsys, _, sd = shared
    jtree = {"diffuser": jsys.params["diffuser"], "ctx": jsys.params["ctx"]["text"]}
    enc_fn = lambda cp, ids: jsys.ctx["text"].apply({"params": cp}, ids)
    vg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jsys.model, "image", "text", enc_fn,
                                                     FREEZE), has_aux=True))
    rs = np.random.RandomState(12)
    x = rs.randn(B, 32, 32, 4).astype(np.float32)
    ids = rs.randint(0, 1000, (B, 16)).astype(np.int32)
    t, n = _draws(0, x.shape)
    (jl, _), jg = vg(jtree, x, ids, t, n)

    psys = _port_system(sd)
    dparams = psys.for_training(torch.float32)
    cparams, encode = psys.trainable_ctx("text", torch.float32)
    tree = {"diffuser": dparams, "ctx": cparams}
    nchw = lambda a: torch.tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    loss, _ = make_loss_fn(psys.model, "image", "text", FREEZE, encode, tree)(
        nchw(x), torch.tensor(ids).long(), torch.tensor(t), nchw(n))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _grads_close(dparams, _by_name(jg["diffuser"]))
    ctx_ref = _by_name(jg["ctx"], prefix="")
    assert set(ctx_ref) == set(cparams)
    _grads_close(cparams, ctx_ref)
    assert all(p.grad is not None for p in cparams.values())
    labels = {optim.parameter_group_of(k) for k, _ in tree_items(tree)}
    assert {"ctx_text_model", "diffuser_image_data", "diffuser_text_data"} <= labels
    assert labels == {joptim.parameter_group_of(("ctx", k.split(".")[0])) for k in cparams} | \
        {optim.parameter_group_of(k) for k in dparams}

    for p in (*dparams.values(), *cparams.values()):
        p.grad = None
    before = {k: p.detach().clone() for k, p in cparams.items()}
    opt, set_lr = optim.get_optimizer("adamw", tree, freeze=FREEZE)
    trainer = Trainer(psys.model, tree, opt, set_lr, ema_decay=0.999, ctx_encode_fn=encode,
                      freeze_groups=FREEZE, log_every=10)
    batches = [{"x": nchw(x).numpy(), "ctx": ids.astype(np.int64)}] * 2
    trainer.run(batches, num_iters=2)
    assert np.isfinite(trainer.last_loss)
    assert all(not torch.equal(p, before[k]) for k, p in cparams.items() if p.dim() > 1)
    assert set(trainer.state.ema.shadow) == {"diffuser", "ctx"}


def _bf16_tree(rs):
    names = ["image.data_blocks.0.w", "image.context_blocks.0.w", "text.data_blocks.0.w",
             "text.context_blocks.0.w", "image.time_embed.0.w"]
    return {n: (rs.randn(37, 5) * 0.05).astype(np.float32) for n in names}


def _jtree(flat):
    tree = {}
    for name, v in flat.items():
        a, b, c, d = name.split(".")
        tree.setdefault(a, {}).setdefault(f"{b}.{c}", {})[d] = jnp.asarray(v, jnp.bfloat16)
    return tree


@pytest.mark.parametrize("pg", [False, True])
def test_bf16_master_weights_match_optax(pg):
    """AdamW (groups, a frozen group, a parameter without gradient) and the
    EMA on bf16 parameters: parameters, both moments and the shadow
    bit-equal to the JAX package's jitted optax update and EMA, four steps
    at lrs off the bf16 grid."""
    rs = np.random.RandomState(3)
    flat = _bf16_tree(rs)
    pg_lrscale = ({"diffuser_image_data": 1.0, "diffuser_image_context": 0.3,
                   "diffuser_text_context": 0.5} if pg else None)
    freeze = FREEZE if pg else None
    params = {n: torch.tensor(v).bfloat16().requires_grad_() for n, v in flat.items()}
    opt, set_lr = optim.get_optimizer("adamw", params, pg_lrscale, freeze, weight_decay=0.01)
    shadow = ema.ema_init(params)
    jp = _jtree(flat)
    tx, jset_lr = joptim.get_optimizer("adamw", jp, pg_lrscale, freeze, weight_decay=0.01)
    js, jema_st = tx.init(jp), jema.ema_init(jp)

    @jax.jit
    def jupd(p, s, e, g):
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
        return p, s, jema.ema_update(e, p, 0.9999)

    no_grad = "image.time_embed.0.w"
    for lr in (1.3e-3, 7e-4, 2.1e-3, 1e-3):
        g = {n: (rs.randn(37, 5) * 0.01).astype(np.float32) for n in flat}
        g[no_grad] = np.zeros((37, 5), np.float32)
        for n, p in params.items():
            p.grad = None if n == no_grad else torch.tensor(g[n]).bfloat16()
        set_lr(opt, lr)
        opt.step()
        ema.ema_update(shadow, params, 0.9999)
        jp, js, jema_st = jupd(jp, jset_lr(js, lr), jema_st, _jtree(g))
    inner = {}
    for label, st in (js.inner_states.items() if pg else [("default", js)]):
        if label == "frozen":
            continue
        inner[label] = (st.inner_state if pg else st).inner_state[0]
    for n, p in params.items():
        a, b, c, d = n.split(".")
        ref = np.asarray(jp[a][f"{b}.{c}"][d].astype(jnp.float32))
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(), ref, err_msg=n)
        np.testing.assert_array_equal(
            shadow.shadow[n].float().numpy(),
            np.asarray(jema_st.shadow[a][f"{b}.{c}"][d].astype(jnp.float32)), err_msg=n)
        label = optim.parameter_group_of(n)
        if pg and label in FREEZE:
            assert p not in opt.state
            continue
        label = label if pg and label in pg_lrscale else "default"
        st = opt.state[p]
        assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16
        for key in ("mu", "nu"):
            jm = getattr(inner[label], key)[a][f"{b}.{c}"][d]
            assert jm.dtype == jnp.bfloat16
            np.testing.assert_array_equal(st[key].float().numpy(),
                                          np.asarray(jm.astype(jnp.float32)), err_msg=(n, key))


def test_bf16_master_weights_train(tmp_path):
    """``for_training(params_dtype=bfloat16)``: bf16 parameters, moments and
    shadow through two Trainer steps; a checkpoint restores them."""
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    with pytest.raises(ValueError):
        system.for_training(torch.float32, torch.bfloat16)
    params = system.for_training(torch.bfloat16, torch.bfloat16)
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    opt, set_lr = optim.get_optimizer("adamw", params, freeze=FREEZE)
    trainer = Trainer(system.model, params, opt, set_lr, ema_decay=0.99, freeze_groups=FREEZE,
                      ckpt_dir=str(tmp_path), log_every=10)
    rs = np.random.RandomState(2)
    batch = {"x": rs.randn(2, 4, 32, 32).astype(np.float32),
             "ctx": rs.randn(2, 16, 96).astype(np.float32)}
    trainer.run([batch] * 2, num_iters=2)
    assert np.isfinite(trainer.last_loss)
    assert all(st["mu"].dtype == torch.bfloat16 for st in opt.state.values())
    assert {s.dtype for s in trainer.state.ema.shadow.values()} == {torch.bfloat16}
    payload = checkpoints.restore_checkpoint(str(tmp_path), "last")
    assert all(torch.equal(v, params[k].detach()) for k, v in payload["params"].items())


def _tiny_trainer(tmp, **kw):
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    params = system.for_training(torch.float32)
    opt, set_lr = optim.get_optimizer("adamw", params, freeze=FREEZE, mu_dtype="bfloat16")
    return Trainer(system.model, params, opt, set_lr, ema_decay=0.99, freeze_groups=FREEZE,
                   ckpt_dir=str(tmp), log_every=10, **kw)


def _load(path):
    return torch.load(path, weights_only=True)


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_saves_equal_sync_saves(tmp_path):
    rs = np.random.RandomState(6)
    batches = [{"x": rs.randn(2, 4, 32, 32).astype(np.float32),
                "ctx": rs.randn(2, 16, 96).astype(np.float32)} for _ in range(4)]
    runs = {}
    for mode in ("sync", "async"):
        tr = _tiny_trainer(tmp_path / mode, ckpt_every=2, async_ckpt=mode == "async")
        tr.run(batches, num_iters=4, seed=3)
        runs[mode] = tr
        assert sorted(os.listdir(tmp_path / mode)) == ["iter_2.pt", "iter_4.pt", "last.pt"]
    for tag in ("iter_2", "iter_4", "last"):
        a, b = (_load(tmp_path / m / f"{tag}.pt") for m in ("sync", "async"))
        assert _equal(a, b), tag


def test_async_snapshot_is_taken_before_the_next_step(tmp_path, monkeypatch):
    """The writer is held back until one more step has changed every
    trainable tensor, the moments and the shadow: the file still holds the
    state at the save."""
    tr = _tiny_trainer(tmp_path, async_ckpt=True)
    rs = np.random.RandomState(7)
    batch = {"x": rs.randn(2, 4, 32, 32).astype(np.float32),
             "ctx": rs.randn(2, 16, 96).astype(np.float32)}
    tr.run([batch], num_iters=1)
    expect = checkpoints._host_copy(checkpoints._payload(tr.state))
    gate = threading.Event()
    real = checkpoints._write
    monkeypatch.setattr(checkpoints, "_write", lambda p, pl: (gate.wait(), real(p, pl)))
    checkpoints.save_checkpoint(str(tmp_path), "held", tr.state, block=False)
    tr.ckpt_dir, tr.async_ckpt = None, False   # no save, no wait for the held one
    tr.run([batch], num_iters=2)
    moved = sum(not torch.equal(v, dict(tree_items(tr.state.params))[k])
                for k, v in expect["params"].items())
    assert moved > 100
    gate.set()
    checkpoints.wait_for_saves()
    assert _equal(_load(tmp_path / "held.pt"), expect)


def test_restore_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    tr = _tiny_trainer(tmp_path, async_ckpt=True)
    real = checkpoints._write
    monkeypatch.setattr(checkpoints, "_write", lambda p, pl: (time.sleep(0.5), real(p, pl)))
    tr.state.step = 7
    checkpoints.save_checkpoint(str(tmp_path), "slow", tr.state, block=False)
    assert not (tmp_path / "slow.pt").exists()
    payload = checkpoints.restore_checkpoint(str(tmp_path), "slow")
    assert payload["step"] == 7
    tr.state.step = 0
    tr.restore(str(tmp_path), "slow")
    assert tr.state.step == 7


def test_a_failed_async_save_raises_on_wait(tmp_path, monkeypatch):
    tr = _tiny_trainer(tmp_path)

    def broken(path, payload):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoints, "_write", broken)
    checkpoints.save_checkpoint(str(tmp_path), "x", tr.state, block=False)
    with pytest.raises(RuntimeError, match="disk full"):
        checkpoints.wait_for_saves()
    checkpoints.wait_for_saves()   # the error is reported once

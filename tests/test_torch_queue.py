"""The serving queue (``vdtpu_torch/serving/queue.py``), port against
``vdtpu.serving.queue.BatchingQueue`` on the tiny config in f32, and the
port's own invariants.

Both systems carry the same weights (``test_torch_i2i.tiny_systems_from_port``).
The two packages draw different random numbers from one seed, so the port's
one draw function, ``queue.request_noise``, is patched to return vdtpu's
row (``jax.random.normal(PRNGKey(seed), row)``), and the port's text
decode is handed vdtpu's per-row Gumbel draws (``fold_in(PRNGKey(seed),
1)`` a row, replayed by ``test_torch_optimus.gumbel_replay``). The JAX side
runs once, one sweep of every flow group at bucket 2, 2 DDIM steps.

The port's invariants, without JAX: at bucket 1 a request equals the
flow's ``inference_*`` call at n = 1 bit for bit; at a fixed bucket its
co-riders change nothing, bit for bit, exact, int8 and int8 + ToMe; across
buckets f32 stays within 1e-5 and int8 within vdtpu's own 0.05. Then the
queue's logic: the deadline, close, the eta check, a failing group.
"""
import copy
import time

import jax
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from test_torch_optimus import gumbel_replay
from vdtpu.serving import api as japi
from vdtpu.serving.queue import BatchingQueue as JBatchingQueue
from vdtpu_torch.serving import queue as pqueue
from vdtpu_torch.serving.api import VDInference, VDSystem
from vdtpu_torch.serving.queue import BatchingQueue

torch.set_num_threads(2)

KW = dict(text_tokenizer=det_tokenizer, output_dim=(64, 64), ddim_steps=2,
          latent_downsample=2, text_latent_dim=96)
# the port's own invariants at a 16^2 latent (the tiny UNet's cost on the CPU)
PKW = dict(KW, output_dim=(32, 32))
VOCAB = 600   # the tiny GPT-2's
# a sweep ends at the largest bucket or after this wait with no arrival
WAIT = dict(max_wait_ms=300.0)


def _images(seed: int, n: int):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, 64, 64, 3).astype(np.float32) for _ in range(n)]


def _mask(seed: int):
    m = np.zeros((1, 64, 64, 1), np.float32)
    m[:, 16:48, 8:40] = 1.0
    return np.roll(m, seed, axis=2)


def _submit_all(q, ims):
    """Two requests of each flow group: t2i, t2t, i2t, i2i at fid 0 and at
    fid 0.5 (colour adjust on one), tcg with a mask (two contexts)."""
    tcg = lambda i, s: q.submit_tcg([{"image": ims[i], "mask": _mask(i), "fcs_lvl": 0.3},
                                     {"image": ims[i + 1], "strength": 0.7}],
                                    "snow on the street", 0.3, s)
    return {"t2i_a": q.submit("a red cat", 1), "t2i_b": q.submit("a blue dog", 2),
            "t2t_a": q.submit_t2t("a red cat", 3), "t2t_b": q.submit_t2t("heavy arms", 4),
            "i2t_a": q.submit_i2t(ims[0], 5), "i2t_b": q.submit_i2t(ims[1], 6),
            "i2i0_a": q.submit_i2i(ims[2], 0.0, 0.5, None, 7),
            "i2i0_b": q.submit_i2i(ims[3], 0.0, 0.3, None, 8),
            "i2i5_a": q.submit_i2i(ims[0], 0.5, 0.5, "Simple", 9),
            "i2i5_b": q.submit_i2i(ims[1], 0.5, 0.8, None, 10),
            "tcg_a": tcg(0, 11), "tcg_b": tcg(2, 12)}


@pytest.fixture(scope="module")
def across():
    """Every flow group of one sweep through both queues on the same draws:
    (JAX results, port results, JAX latents, port latents) by request."""
    jsys, psys, _ = tiny_systems_from_port()
    ims = _images(20, 4)
    jvdi = japi.VDInference(jsys, **KW)
    jlat, plat = [], []
    jdecode = jvdi._decode_texts

    def jrecord(x, keys):
        jlat.append((np.asarray(x), np.asarray(keys)))
        return jdecode(x, keys)

    jvdi._decode_texts = jrecord
    with JBatchingQueue(jvdi, buckets=(2, 12), max_wait_ms=2000.0) as q:
        jres = {k: np.asarray(f.result(600)) for k, f in _submit_all(q, ims).items()}

    vae = psys.vae["text"]
    decode_ids = vae.decode_ids

    def replayed(z, generator=None, temperature=1.0, gumbel_table=None):
        _, keys = jlat[len(plat)]
        plat.append(z.numpy().copy())
        return decode_ids(z, None, temperature, gumbel_replay(keys, len(keys), VOCAB))

    mp = pytest.MonkeyPatch()
    mp.setattr(vae, "decode_ids", replayed)
    mp.setattr(pqueue, "request_noise", lambda seed, row, dtype, device: (
        np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, *row))),
        torch.Generator().manual_seed(seed)))
    try:
        with BatchingQueue(VDInference(psys, **KW), buckets=(2, 12), max_wait_ms=2000.0) as q:
            pres = {k: f.result(600) for k, f in _submit_all(q, ims).items()}
    finally:
        mp.undo()
    return jres, pres, [x for x, _ in jlat], plat


# f32 end to end, 2 guided steps, then the KL-f8 decoder: summation order
@pytest.mark.parametrize("group", ["t2i", "i2i0", "i2i5", "tcg"])
def test_image_groups_match_jax(across, group):
    jres, pres, _, _ = across
    for k in ("a", "b"):
        out, ref = pres[f"{group}_{k}"].numpy(), jres[f"{group}_{k}"]
        assert out.shape == ref.shape == (64, 64, 3)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert np.abs(jres[f"{group}_a"] - jres[f"{group}_b"]).max() > 1e-3


# latents to relative L2 1e-4 (guidance amplifies summation-order
# differences, test_torch_text_flows), strings equal on vdtpu's draws
def test_text_groups_match_jax(across):
    jres, pres, jlat, plat = across
    assert len(jlat) == len(plat) == 2   # the i2t group, then the t2t group
    for a, b in zip(plat, jlat):
        assert a.shape == b.shape == (2, 96)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4
    for k in ("t2t_a", "t2t_b", "i2t_a", "i2t_b"):
        assert isinstance(pres[k], str) and pres[k] == jres[k]


@pytest.fixture(scope="module")
def psys():
    return tiny_systems_from_port()[1]


FLOWS = ["t2i", "t2t", "i2t", "i2i0", "i2i5", "dcg", "tcg", "mcg"]


def _requests(ims, mask):
    """(submit(q), direct(vdi) at n = 1) of one request of each flow; an
    odd-sized input image, regularized on the way in."""
    tcg_ctxs = [{"image": ims[0], "mask": mask, "fcs_lvl": 0.3},
                {"image": ims[1], "strength": 0.7}]
    mcg_ctxs = [{"image": ims[1]}, {"image": ims[2], "strength": 0.5}, {"image": ims[0]}]
    return {
        "t2i": (lambda q: q.submit("a red cat", 3), lambda v: v.inference_t2i("a red cat", 3)),
        "t2t": (lambda q: q.submit_t2t("a red cat", 4),
                lambda v: v.inference_t2t("a red cat", 4)),
        "i2t": (lambda q: q.submit_i2t(ims[0], 5), lambda v: v.inference_i2t(ims[0], 5)),
        "i2i0": (lambda q: q.submit_i2i(ims[0], 0.0, 0.5, None, 6),
                 lambda v: v.inference_i2i(ims[0], 0.0, 0.5, None, 6)),
        "i2i5": (lambda q: q.submit_i2i(ims[1], 0.5, 0.3, "Simple", 7),
                 lambda v: v.inference_i2i(ims[1], 0.5, 0.3, "Simple", 7)),
        "dcg": (lambda q: q.submit_dcg(ims[2], 0.5, "a dog", 0.5, 8),
                lambda v: v.inference_dcg(ims[2], 0.5, "a dog", 0.5, 8)),
        "tcg": (lambda q: q.submit_tcg(tcg_ctxs, "snow", 0.3, 9),
                lambda v: v.inference_tcg(tcg_ctxs, "snow", 0.3, 9)[1]),
        "mcg": (lambda q: q.submit_mcg(mcg_ctxs, None, 0.0, 10),
                lambda v: v.inference_mcg(mcg_ctxs, None, 0.0, 10)[1]),
    }


@pytest.fixture(scope="module")
def solo(psys):
    """Each flow's request through the queue at bucket 1 (all flows in one
    sweep) and its direct call at n = 1."""
    rs = np.random.RandomState(21)
    ims = [rs.rand(1, 50, 70, 3).astype(np.float32) for _ in range(3)]
    mask = (rs.rand(1, 40, 40, 1) > 0.5).astype(np.float32)
    reqs = _requests(ims, mask)
    vdi = VDInference(psys, n_sample_image=1, n_sample_text=1, **PKW)
    with BatchingQueue(vdi, buckets=(1, 16), **WAIT) as q:
        futs = {k: submit(q) for k, (submit, _) in reqs.items()}
        queued = {k: f.result(600) for k, f in futs.items()}
    return queued, {k: direct(vdi) for k, (_, direct) in reqs.items()}


@pytest.mark.parametrize("flow", FLOWS)
def test_bucket_one_equals_the_direct_call(solo, flow):
    queued, direct = solo
    if flow in ("t2t", "i2t"):
        assert direct[flow] == [queued[flow]]
    else:
        assert direct[flow].shape == (1, 32, 32, 3)
        assert torch.equal(queued[flow], direct[flow][0])


def test_fid_one_returns_the_regularized_input(psys):
    im = np.random.RandomState(22).rand(1, 40, 90, 3).astype(np.float32)
    vdi = VDInference(psys, n_sample_image=1, **PKW)
    with BatchingQueue(vdi, buckets=(4,), max_wait_ms=1.0) as q:
        out = q.submit_i2i(im, 1.0, 0.5, None, 9).result(60)
    assert torch.equal(out, vdi.inference_i2i(im, 1.0, 0.5, None, 9)[0])


def _with_riders(vdi, riders, buckets=(4,)):
    """The request ("a red cat", 0) among ``riders`` at a fixed bucket."""
    with BatchingQueue(vdi, buckets=buckets, **WAIT) as q:
        f = q.submit("a red cat", 0)
        for text, seed in riders:
            q.submit(text, seed)
        return f.result(600)


@pytest.fixture(scope="module")
def int8_sys():
    """Its own tiny system (enable_int8 is state of the system), calibrated
    on the t2i flow."""
    sys = tiny_systems_from_port(seed=1)[1]
    return sys.enable_int8(image_size=32, latent_downsample=2, n=1,
                           flows=(("image", "text"),))


@pytest.mark.parametrize("mode", ["exact", "int8", "int8_tome"])
def test_co_riders_change_nothing_at_a_fixed_bucket(psys, int8_sys, mode):
    sys = psys if mode == "exact" else int8_sys
    sys.enable_tome(0.75, min_tokens=256) if mode == "int8_tome" else sys.enable_tome(0)
    try:
        vdi = VDInference(sys, **PKW)
        a = _with_riders(vdi, [("a blue dog", 1), ("a green bird", 2), ("a red cat", 7)])
        b = _with_riders(vdi, [])   # padding only
    finally:
        sys.enable_tome(0)
    assert torch.equal(a, b)
    assert a.shape == (32, 32, 3) and torch.isfinite(a).all()


@pytest.mark.parametrize("mode,tol", [("exact", 1e-5), ("int8", 0.05)])
def test_across_buckets(psys, int8_sys, mode, tol):
    vdi = VDInference(psys if mode == "exact" else int8_sys, **PKW)
    packed = _with_riders(vdi, [("a blue dog", 1), ("a green bird", 2)])
    alone = _with_riders(vdi, [], buckets=(1,))
    assert float((packed - alone).abs().max()) <= tol


def _recording(vdi, sizes):
    """A copy of vdi whose samplers record each dispatched batch size."""
    probe = copy.copy(vdi)

    def sample(gen, shape, x_info, c_info):
        sizes.append(shape[0])
        return vdi._sample(gen, shape, x_info, c_info)

    def sample_multi(gen, shape, x_info, c_info_list):
        sizes.append(shape[0])
        return vdi._sample_multi(gen, shape, x_info, c_info_list)

    probe._sample, probe._sample_multi = sample, sample_multi
    return probe


def test_deadline_dispatches_a_padded_partial_bucket(psys):
    vdi = VDInference(psys, **PKW)
    with BatchingQueue(vdi, buckets=(4,), max_wait_ms=1.0) as q:
        warm = q.submit("warm", 5).result(600)
    sizes = []
    # a 30 s wait a gap: without the deadline a lone request would sit in
    # _gather for 90 s before its batch started
    with BatchingQueue(_recording(vdi, sizes), buckets=(4,), max_wait_ms=30_000.0,
                       deadline_ms=250.0) as q:
        t0 = time.monotonic()
        img = q.submit("warm", 5).result(600)
        dt = time.monotonic() - t0
    assert sizes == [4]           # still padded to the bucket
    assert dt < 20.0, f"the deadline did not cut the coalescing wait ({dt:.1f} s)"
    assert torch.equal(img, warm)


def test_deadline_still_coalesces_within_its_budget(psys):
    sizes = []
    with BatchingQueue(_recording(VDInference(psys, **PKW), sizes), buckets=(2,),
                       max_wait_ms=2000.0, deadline_ms=10_000.0) as q:
        a, b = q.submit("twin", 7), q.submit("twin", 7)
        assert torch.equal(a.result(600), b.result(600))
    assert sizes == [2]           # one coalesced dispatch


def test_groups_split_by_flow_and_level(psys):
    ims = _images(23, 2)
    sizes = []
    with BatchingQueue(_recording(VDInference(psys, **PKW), sizes), buckets=(1, 2, 8),
                       **WAIT) as q:
        futs = [q.submit_i2i(ims[0], 0.5, 0.5, None, 3), q.submit_i2i(ims[1], 0.0, 0.5, None, 4),
                q.submit_i2i(ims[1], 0.5, 0.2, None, 5),
                q.submit_dcg(ims[0], 0.5, "a boat", 0.4, 6),
                q.submit_dcg(ims[1], 0.5, "a plane", 0.8, 7)]
        for f in futs:
            assert f.result(600).shape == (32, 32, 3)
    # i2i at 1 forward step (two requests) and from noise, dcg at two text
    # strengths: four groups
    assert sorted(sizes) == [1, 1, 1, 2]


def test_close_drains_and_refuses_later_submits(psys):
    q = BatchingQueue(VDInference(psys, **PKW), buckets=(2,), max_wait_ms=50.0)
    f = q.submit("drain me", 3)
    q.close()
    assert f.result(600).shape == (32, 32, 3)
    with pytest.raises(RuntimeError, match="closed"):
        q.submit("too late", 4)
    q.close()   # a second close is a no-op
    assert not q._worker.is_alive()


def test_eta_nonzero_is_refused(psys):
    with pytest.raises(ValueError, match="eta=0"):
        BatchingQueue(VDInference(psys, ddim_eta=0.3, **PKW))


def test_a_failing_group_fails_only_its_own_futures(psys):
    """No CLIP tokenizer: the t2i group raises, the i2i group of the same
    sweep is served."""
    vdi = VDInference(psys, **dict(PKW, text_tokenizer=None))
    im = _images(24, 1)[0]
    with BatchingQueue(vdi, buckets=(1, 4), **WAIT) as q:
        bad = [q.submit("a red cat", 1), q.submit("a dog", 2)]
        good = q.submit_i2i(im, 0.0, 0.5, None, 3)
        assert good.result(600).shape == (32, 32, 3)
        for f in bad:
            with pytest.raises(RuntimeError, match="tokenizer"):
                f.result(600)


def test_the_worker_records_no_autograd_graph(psys):
    """Grad mode is per thread: the worker runs its groups under no_grad
    itself, whatever the caller's mode."""
    sys = VDSystem("vd_test_tiny", device="cpu").init_random(2)
    sys.model.diffuser.requires_grad_(True)
    with torch.enable_grad(), BatchingQueue(VDInference(sys, **PKW), buckets=(1,),
                                            max_wait_ms=1.0) as q:
        out = q.submit("a red cat", 3).result(600)
    assert not out.requires_grad and out.grad_fn is None

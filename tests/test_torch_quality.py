"""The serving-policy quality gate (``python -m vdtpu_torch.quality``) on the
tiny config on the CPU: n = 1, four f32 steps (three for DPM-Solver++),
encoder-reuse warmup 1 so reuse steps exist (``run``'s ``_ladder``), ToMe
at the 32^2 latent's own map (1024 tokens), as the gate derives it.

Each row's latent must equal, bit for bit, a direct ``DDIMSampler.sample``
(and ``enable_tome``) call in that row's mode on the same x_T and
conditioning; the row metrics must equal ``scripts/int8_quality.py``'s
formulas (a numpy oracle of its lines 468-496); the CLIP-sim column must
equal vdtpu's ``ClipSimilarityEvaluator`` on the same embeddings to its
six printed decimals. The weight regimes: the fill is N(0, 0.02) in every
diffuser tensor (pooled std within 2%); the surrogate's conv and linear
weights lie within +-1/sqrt(fan_in) but for the reference's zero-initialized
layers, which are N(0, 0.02), with no all-zero tensor left.
"""
import json

import numpy as np
import pytest
import torch
from torch import nn

from vdtpu.training.evaluator import ClipSimilarityEvaluator as JClipSimilarityEvaluator
from vdtpu_torch import quality
from vdtpu_torch.models.layers import GroupNorm32
from vdtpu_torch.ops.quant import QuantPolicy

torch.set_num_threads(2)

N, STEPS, DPMPP, LATENT, SEED = 1, 4, 3, 32, 0
LADDER = dict(dpmpp_steps=DPMPP, warmup=1)
RUN_KW = dict(n=N, steps=STEPS, latent=LATENT, seed=SEED, _ladder=LADDER)
ARGV = ["--device", "cpu", "--config", "vd_test_tiny", "--dtype", "float32", "--n", str(N),
        "--steps", str(STEPS), "--image-size", str(2 * LATENT), "--latent-downsample", "2"]


@pytest.fixture(scope="module")
def gate_run():
    """(system, the JSON, every variant's (latent, image) as recorded)."""
    system = quality.build_system("vd_test_tiny", torch.float32, "cpu", False, SEED)
    seen = {}

    def observe(name, sys_, thunk):
        assert sys_ is system
        x, img, traj = thunk()
        seen[name] = (x.clone(), img.clone())
        return x, img, traj

    out = quality.run(system, observe=observe, **RUN_KW)
    return system, out, seen


def _direct(system, gate, steps, **modes):
    return system.sampler.sample(
        None, steps, tuple(gate.xt.shape), {"type": "image", "xt": gate.xt},
        {"type": "text", "conditioning": gate.cond, "unconditional_conditioning": gate.uncond,
         "unconditional_guidance_scale": quality.SCALE},
        dtype=system.dtype, device=system.device, **modes)


def test_rows_equal_direct_sampler_calls(gate_run):
    system, out, seen = gate_run
    rows = quality.row_modes(STEPS, True, **LADDER)
    assert list(seen) == ["bf16_exact", *[r[0] for r in rows], "bf16_exact_repeat"]
    gate = quality.Gate(system, N, LATENT, SEED)
    system.set_quant_policy(None)
    torch.testing.assert_close(_direct(system, gate, STEPS), seen["bf16_exact"][0],
                               atol=0, rtol=0)
    assert out["bf16_exact_repeat_bit_equal"]
    system.set_quant_policy(QuantPolicy())       # the calibrated state of the run
    try:
        for name, modes, tome in rows:
            steps = modes.pop("steps")
            system.enable_tome(tome, LATENT * LATENT)
            try:
                x = _direct(system, gate, steps, **modes)
            finally:
                system.enable_tome(0)
            torch.testing.assert_close(x, seen[name][0], atol=0, rtol=0, msg=name)
    finally:
        system.set_quant_policy(None)
    # ToMe merged at this size: its rows left the plain int8 row
    assert not torch.equal(seen["int8+tome0.75"][0], seen["int8"][0])


def _script_metrics(x_v, img_v, x_ref, img_ref):
    """scripts/int8_quality.py:469-496 as written."""
    def cos(a, b):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    rng = img_ref.max() - img_ref.min() + 1e-9
    mae = float(np.abs(img_v - img_ref).mean())
    psnr = 10 * np.log10(rng ** 2 / max(((img_v - img_ref) ** 2).mean(), 1e-12))
    return {"final_latent_cos": round(cos(x_v, x_ref), 5),
            "final_latent_rel_err": round(
                float(np.abs(x_v - x_ref).mean() / (np.abs(x_ref).mean() + 1e-9)), 5),
            "decoded_mae": round(mae, 5),
            "decoded_psnr_db": round(float(psnr), 2)}


def test_row_metrics_match_the_script(gate_run):
    _, out, seen = gate_run
    x_ref, img_ref = (t.numpy() for t in seen["bf16_exact"])
    names = [r[0] for r in quality.row_modes(STEPS, True, **LADDER)]
    assert [k for k, v in out.items() if isinstance(v, dict) and "decoded_mae" in v] == names
    for name in names:
        x, img = (t.numpy() for t in seen[name])
        assert out[name] == _script_metrics(x, img, x_ref, img_ref), name
    assert out["steps"] == STEPS and out["batch"] == N and out["weights"] == "random_fill"
    assert len(out["int8_step_cos"]) == len(range(0, STEPS, 10)) + 1
    assert 0.9 < out["int8_step_cos_min"] <= 1.0 and out["int8_step_mse_max"] >= 0.0


def test_clip_sim_matches_jax_evaluator(gate_run):
    system, out, seen = gate_run
    gate = quality.Gate(system, N, LATENT, SEED)
    img_ref = seen["bf16_exact"][1]
    lo, hi = float(img_ref.min()), float(img_ref.max())
    zt = system.clip_text_features(gate.ids).float().numpy()
    for name, (_, img) in seen.items():
        if name == "bf16_exact_repeat":
            continue
        zi = system.clip_image_features(((img - lo) / max(hi - lo, 1e-9)).clamp(0, 1))
        ev = JClipSimilarityEvaluator(lambda _: zi.float().numpy(), lambda _: zt)
        ev.add_batch(None, None)
        want = ev.summarize()["clip_similarity"]
        assert abs(out["clip_sim"][name] - want) <= 1e-6, name
        assert out["clip_sim_delta_vs_int8"][name] == round(
            out["clip_sim"][name] - out["clip_sim"]["int8"], 6)


def _diffuser_tensors(system):
    return [p for p in system.model.diffuser.parameters()]


def test_random_fill_regime():
    system = quality.build_system("vd_test_tiny", torch.float32, "cpu", False, SEED)
    flat = torch.cat([p.flatten() for p in _diffuser_tensors(system)])
    assert abs(float(flat.std()) / quality.FILL_STD - 1.0) < 0.02
    assert abs(float(flat.mean())) < 1e-3
    norms = [m.weight for m in system.model.diffuser.modules()
             if isinstance(m, (GroupNorm32, nn.LayerNorm))]
    assert norms and all(float(w.abs().max()) < 0.2 for w in norms)   # no unit scales left


def test_surrogate_regime():
    system = quality.build_system("vd_test_tiny", torch.float32, "cpu", True, SEED)
    assert all(bool(p.any()) for p in _diffuser_tensors(system))
    zeroed = 0
    for m in system.model.diffuser.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if getattr(m.weight, "zero_init", False):   # the reference's zero_module
                zeroed += 1
                assert 0.015 < float(m.weight.std()) < 0.025
                continue
            bound = m.weight[0].numel() ** -0.5
            for p in (m.weight, m.bias):
                if p is not None:
                    assert float(p.abs().max()) <= bound * (1 + 1e-6)
            assert float(m.weight.abs().max()) > 0.5 * bound     # uniform over the bound
        elif isinstance(m, (GroupNorm32, nn.LayerNorm)):
            torch.testing.assert_close(m.weight, torch.ones_like(m.weight))
            assert 0.005 < float(m.bias.std()) < 0.05          # zeros redrawn
    assert zeroed > 0
    # the port's own init elsewhere: the VAE is untouched by the regime
    ref = quality.build_system("vd_test_tiny", torch.float32, "cpu", False, SEED)
    for a, b in zip(system.vae["image"].parameters(), ref.vae["image"].parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_clip_sweep_one_row_per_mode(capsys):
    out = quality.main(ARGV + ["--clip-sweep", "q99.9,sigma4"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert list(out["clip_sweep"]) == ["none", "q99.9", "sigma4"]
    assert out["clip_sweep"]["none"]["median_scale_ratio"] == 1.0
    for row in out["clip_sweep"].values():
        assert set(row) == {"median_scale_ratio", "step1_cos", "final_latent_cos",
                            "final_latent_rel_err", "decoded_mae", "decoded_psnr_db"}
        assert all(np.isfinite(v) for v in row.values())
    # clipping shrinks scales
    assert out["clip_sweep"]["q99.9"]["median_scale_ratio"] < 1.0


def test_sweep_none_row_is_the_gate_int8_row(gate_run):
    """The sweep's "none" recalibration takes the gate's probes again, so its
    int8 exact-path row is the gate's int8 row."""
    system, out, _ = gate_run
    sweep = quality.run(system, clip_sweep=["q99.9"], **RUN_KW)
    none = sweep["clip_sweep"]["none"]
    assert {k: none[k] for k in out["int8"]} == out["int8"]


def test_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality.main(ARGV[2:])

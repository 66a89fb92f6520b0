"""The training launcher, port against the JAX package, on the tiny config
and synthetic shards.

- ``encode_batches``: chunked equal to whole batches, and the port's
  latents and contexts against vdtpu's ``encode_batches`` on shared
  weights (f32, summation order only);
- ``cached_latent_batches``: refuses a missing count, stops the pipeline's
  producer thread, frees the towers, replays as its docstring says;
- the experiment literal against ``vd_laion_t2i.yaml``; the run dir;
- ``main`` on the CPU: trains with async saves, a resumed run equal bit
  for bit to the uninterrupted one, ``--eval`` writing a ``summary.yaml``
  that ``yaml.safe_load`` reads and that equals vdtpu's own writer's text;
  ``train.tp`` other than 1 raises.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from vdtpu.training import launch as jlaunch
from vdtpu_torch.config.experiments import VD_LAION_T2I, load_experiment
from vdtpu_torch.data.benchmark import synthesize_shards
from vdtpu_torch.data.tokenizers import bytes_to_unicode
from vdtpu_torch.data.webdataset import ImageTextPipeline, ShardIndex
from vdtpu_torch.training import launch
from vdtpu_torch.training.checkpoints import restore_checkpoint
from vdtpu_torch.training.ema import tree_items
from vdtpu_torch.training.experiment import Experiment

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


def _raw_batches(n=2, b=5, size=64):
    rs = np.random.RandomState(4)
    return [{"image": rs.rand(b, size, size, 3).astype(np.float32),
             "caption": [f"a photo number {i} of {j}" for i in range(b)]} for j in range(n)]


@pytest.mark.parametrize("c_type", ["text", "image"])
def test_encode_batches_chunked_equals_full_and_jax(systems, c_type):
    jsys, psys, _ = systems
    raw = _raw_batches()
    tok = det_tokenizer
    full = list(launch.encode_batches(iter(raw), psys, "image", c_type, tok))
    for chunk in (2, 3, 99):
        chunked = list(launch.encode_batches(iter(raw), psys, "image", c_type, tok,
                                             encode_chunk=chunk))
        for a, b in zip(full, chunked):
            np.testing.assert_allclose(a["x"], b["x"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a["ctx"], b["ctx"], rtol=1e-5, atol=1e-6)
    ref = list(jlaunch.encode_batches(iter(raw), jsys, "image", c_type, tok, encode_chunk=2))
    assert len(full) == len(ref) == 2
    for a, b in zip(full, ref):
        assert a["x"].dtype == np.float32 and a["x"].shape == (5, 4, 32, 32)
        np.testing.assert_allclose(a["x"], np.moveaxis(np.asarray(b["x"]), -1, 1),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a["ctx"], np.asarray(b["ctx"]), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def png_shards(tmp_path_factory):
    return synthesize_shards(str(tmp_path_factory.mktemp("png")), n_shards=2, per_shard=6,
                             size=64, n_other=2)


def test_cached_latent_batches(png_shards):
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    pipe = ImageTextPipeline(ShardIndex.from_dir(png_shards), batch_size=2, image_size=64,
                             shuffle_buffer=2, prefetch=1, num_threads=2)
    for bad in (None, 0, -1):
        with pytest.raises(ValueError, match="positive"):
            launch.cached_latent_batches(pipe, system, tokenizer=det_tokenizer, num_batches=bad)
    replay = launch.cached_latent_batches(pipe, system, tokenizer=det_tokenizer,
                                          num_batches=3, seed=7)
    assert pipe.producers and not any(t.is_alive() for t in pipe.producers)
    assert not system.vae and not system.ctx          # the towers are gone
    assert len(replay.cache) == 3 and replay.cache[0]["x"].shape == (2, 4, 32, 32)
    it = iter(replay)
    got = [next(it) for _ in range(7)]
    want = [replay.cache[i] for e in range(3) for i in np.random.default_rng([7, e])
            .permutation(3)][:7]
    assert all(a is b for a, b in zip(got, want))
    assert any(not np.array_equal(replay.order(0), replay.order(e)) for e in (1, 2, 3))
    replay.start_step = 4            # a run restored at step 4: epoch 1, one batch in
    it = iter(replay)
    assert all(next(it) is b for b in want[4:7])


def test_experiment_literal_matches_the_yaml():
    with open(os.path.join(ROOT, "vdtpu", "config", "experiments", "vd_laion_t2i.yaml")) as f:
        ref = yaml.safe_load(f)
    assert VD_LAION_T2I == ref
    assert load_experiment("vd_laion_t2i") == ref
    with pytest.raises(FileNotFoundError):
        load_experiment("no_such_experiment")


def test_experiment_run_dir(tmp_path):
    exp = Experiment({"name": "x", "a": 1}, log_root=str(tmp_path), debug=True).initiate()
    assert exp.log_dir == os.path.join(str(tmp_path), "x", "999999999999_debug")
    assert os.path.isdir(exp.weight_dir) and os.path.isdir(exp.tb_dir)
    assert os.path.exists(os.path.join(exp.log_dir, "code", "vdtpu_torch", "training",
                                       "launch.py"))
    again = Experiment.resume(exp.log_dir)
    assert again.cfg == {"name": "x", "a": 1}
    assert os.path.exists(os.path.join(exp.log_dir, "config.json.version0"))


def _workspace(tmp_path, **train):
    synthesize_shards(str(tmp_path / "shards"), n_shards=2, per_shard=6, size=64, n_other=2)
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: tiny\n")
    cfg = {"name": "launch_tiny", "model": "vd_test_tiny", "bf16": False, "pretrained": None,
           "clip_vocab": str(tmp_path / "vocab.json"),
           "clip_merges": str(tmp_path / "merges.txt"), "clip_max_length": 16,
           "data": {"shards": str(tmp_path / "shards"), "batch_size": 4, "image_size": 64,
                    "shuffle_buffer": 4, "cache_latents": 2, "encode_chunk": 2},
           "train": {"x_type": "image", "c_type": "text", "num_iters": 4, "batch_size": 4,
                     "gradacc_every": 2, "tp": 1, "optimizer": "adamw",
                     "optimizer_args": {"weight_decay": 0.01},
                     "pg_lrscale": dict(VD_LAION_T2I["train"]["pg_lrscale"]),
                     "scheduler": {"type": "constant", "lr": 1e-4}, "ema_decay": 0.999,
                     "log_every": 1, "ckpt_every": 2, "async_ckpt": True,
                     "freeze": ["diffuser_text_data"], **train},
           "eval": {"ddim_steps": 2, "latent_size": 32, "max_batches": 1,
                    "sampler": "dpmpp2m"}}
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _set(run_dir, **train):
    path = os.path.join(run_dir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["train"].update(train)
    with open(path, "w") as f:
        json.dump(cfg, f)


def test_main_trains_resumes_bit_for_bit_and_evals(tmp_path, monkeypatch, capsys):
    cfg = _workspace(tmp_path)
    monkeypatch.chdir(tmp_path)
    straight = launch.main(["--config", cfg, "--device", "cpu", "--signature", "a"])
    run_a = straight["exp"].log_dir
    assert sorted(os.listdir(straight["exp"].weight_dir)) == ["iter_2.pt", "iter_4.pt",
                                                              "last.pt"]
    log = open(os.path.join(run_a, "train.log")).read()
    assert all(f"Iter {i} |" in log for i in range(1, 5))
    params = dict(tree_items(straight["trainer"].state.params))
    frozen = [k for k in params if k.startswith("text.data_blocks")]
    init = launch.build_system(json.load(open(cfg)), type("A", (), {"seed": None,
                                                                     "device": "cpu"}), True)[1]
    assert frozen and all(torch.equal(params[k], init[k]) for k in frozen)
    assert sum(not torch.equal(p, init[k]) for k, p in params.items()) > 50

    # two steps, then a resume to four, in a run dir of its own
    with open(cfg) as f:
        two = json.load(f)
    two["train"]["num_iters"] = 2
    cfg2 = str(tmp_path / "exp2.json")
    with open(cfg2, "w") as f:
        json.dump(two, f)
    short = launch.main(["--config", cfg2, "--device", "cpu", "--signature", "b"])
    run_b = short["exp"].log_dir
    assert sorted(os.listdir(short["exp"].weight_dir)) == ["iter_2.pt", "last.pt"]
    _set(run_b, num_iters=4)
    capsys.readouterr()
    resumed = launch.main(["--config", cfg2, "--device", "cpu", "--resume_dir", run_b])
    assert "at step 2" in capsys.readouterr().out and resumed["trainer"].state.step == 4
    assert os.path.exists(os.path.join(run_b, "config.json.version0"))
    a = restore_checkpoint(straight["exp"].weight_dir, "last")
    b = restore_checkpoint(resumed["exp"].weight_dir, "last")
    assert a["step"] == b["step"] == 4
    assert all(torch.equal(x, b["params"][k]) for k, x in a["params"].items())
    assert all(torch.equal(x, b["ema"]["shadow"][k]) for k, x in a["ema"]["shadow"].items())
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[i]["mu"], sb[i]["mu"]) and torch.equal(sa[i]["nu"], sb[i]["nu"])
        for i in sa)

    summary = launch.main(["--config", cfg, "--device", "cpu", "--eval", "--resume_dir", run_a])
    assert "loaded trained checkpoint 'last'" in capsys.readouterr().out
    path = os.path.join(run_a, "eval", "summary.yaml")
    with open(path) as f:
        text = f.read()
    assert yaml.safe_load(text) == {k: float(v) for k, v in summary.items()}
    assert text == yaml.safe_dump({k: float(v) for k, v in summary.items()})


def test_summary_yaml_matches_jax_writer(tmp_path):
    summary = {"fid": 12.5, "clip_similarity": 0.0161700126587592, "tiny": 1e-5,
               "big": 3e20, "neg": -2.0, "nan": float("nan"), "inf": float("inf")}
    path = tmp_path / "summary.yaml"
    launch.write_summary(str(path), summary)
    ref = yaml.safe_dump({k: float(v) for k, v in summary.items()})
    assert path.read_text() == ref
    back = yaml.safe_load(path.read_text())
    assert back.keys() == summary.keys() and np.isnan(back["nan"])


def test_model_args_overlay_the_config():
    """``model_args`` replaces keys of the config's args, as vdtpu's
    launcher passes them to its VDSystem."""
    from vdtpu_torch.serving.api import VDSystem
    cfg = {"model": "vd_test_tiny", "model_args": {"timesteps": 500}, "bf16": False}
    args = type("A", (), {"seed": None, "device": "cpu"})
    system, _ = launch.build_system(cfg, args, training=False)
    assert system.cfg["args"]["timesteps"] == 500 and system.model.schedule.num_timesteps == 500
    assert VDSystem("vd_test_tiny", device="cpu").cfg["args"]["timesteps"] == 1000


def test_tp_other_than_one_raises(tmp_path, monkeypatch):
    cfg = _workspace(tmp_path, tp=2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="tp=2"):
        launch.main(["--config", cfg, "--device", "cpu", "--debug"])

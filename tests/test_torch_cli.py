"""The port's headless CLI (``vdtpu_torch/serving/cli.py``) on the tiny
config: t2i writes its PNGs (the standard library's writer, read back by
its reader and by PIL, pixel for pixel the flow's output), i2t and t2t print
their texts, ``--device cpu``; without it the CLI runs on the card and
refuses where there is none."""
import numpy as np
import pytest
import torch

from _tiny import write_tiny_clip_vocab
from vdtpu_torch.serving import cli

torch.set_num_threads(2)

GEOMETRY = ["--config", "vd_test_tiny", "--size", "32", "--latent-downsample", "2",
            "--text-latent-dim", "96", "--steps", "2", "--clip-max-length", "16"]


@pytest.fixture
def common(tmp_path):
    vocab, merges = tmp_path / "vocab.json", tmp_path / "merges.txt"
    write_tiny_clip_vocab(str(vocab), str(merges))
    return GEOMETRY + ["--clip-vocab", str(vocab), "--clip-merges", str(merges),
                       "--out", str(tmp_path / "out"), "--device", "cpu"]


def test_cli_t2i_writes_the_flows_images(tmp_path, common, capsys):
    from PIL import Image
    cli.main(["t2i", "--text", "a village in the snow", "--seed", "3"] + common)
    pngs = sorted((tmp_path / "out").glob("t2i_*.png"))
    assert len(pngs) == 2 and str(pngs[0]) in capsys.readouterr().out
    args = ["t2i", "--text", "a village in the snow", "--seed", "3"] + common
    vdi = cli.build_inference(cli.parse_args(args))
    want = (vdi.inference_t2i("a village in the snow", 3).numpy() * 255).astype(np.uint8)
    for png, ref in zip(pngs, want):
        arr = cli.read_png(str(png))
        assert arr.shape == (32, 32, 3) and arr.dtype == np.uint8
        np.testing.assert_array_equal(arr, ref)
        np.testing.assert_array_equal(np.asarray(Image.open(png)), ref)


def test_cli_i2t_and_t2t_print_texts(tmp_path, common, capsys):
    from PIL import Image
    img = tmp_path / "in.png"
    Image.fromarray((np.random.RandomState(0).rand(40, 48, 3) * 255)
                    .astype(np.uint8)).save(img)
    cli.main(["i2t", "--image", str(img), "--seed", "3", "--n-texts", "2"] + common)
    assert len(capsys.readouterr().out.rstrip("\n").split("\n")) == 2
    cli.main(["t2t", "--text", "a red cat", "--seed", "4", "--n-texts", "3"] + common)
    assert len(capsys.readouterr().out.rstrip("\n").split("\n")) == 3


def test_cli_runs_on_the_card_unless_told(common):
    argv = ["t2i", "--text", "a cat"] + common[:-2]   # no --device
    assert cli.parse_args(argv).device is None
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_png_round_trip_and_checks(tmp_path):
    rgb = (np.random.RandomState(1).rand(7, 5, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    cli.write_png(path, rgb)
    np.testing.assert_array_equal(cli.read_png(path), rgb)
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0xFF   # a byte of the IDAT chunk
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        cli.read_png(path)

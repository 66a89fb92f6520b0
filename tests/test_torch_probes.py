"""The three Mosaic probes (``scripts/mosaic_probe.py``, rows 12-14 of the
kernel table): each plain version of ``vdtpu_torch/ops/probes.py`` against
the script's own Pallas kernel run in interpret mode on the CPU, exactly.
The script is imported by path and not edited; its kernels go through
``pl.pallas_call(..., interpret=True)`` with the script's block layout
(one block, the scratch buffers it declares)."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vdtpu_torch import probes
from vdtpu_torch.ops.probes import (
    probe_s8mm, probe_scratch, probe_scratch_plain, probe_shift, s8_convert)

torch.set_num_threads(2)

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "mosaic_probe.py")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("mosaic_probe", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("data", ["random", "ones"])
def test_s8mm_matches_pallas(script, data):
    m, k, n = 256, 288, 128
    rs = np.random.RandomState(0)
    if data == "ones":
        a, b = np.ones((m, k), np.int8), np.ones((k, n), np.int8)
    else:
        a = rs.randint(-128, 128, (m, k)).astype(np.int8)
        b = rs.randint(-128, 128, (k, n)).astype(np.int8)
    ref = np.asarray(pl.pallas_call(
        script.mm_kernel, out_shape=jax.ShapeDtypeStruct((m, n), jnp.int32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    out = probe_s8mm(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    if data == "ones":
        assert (ref == k).all()
    else:
        assert np.abs(ref).max() > 1 << 16   # sums well past 16 bits


def _shift_pallas(script, x):
    m, c = x.shape
    return np.asarray(pl.pallas_call(
        script.shift_kernel, out_shape=jax.ShapeDtypeStruct((m, c), jnp.int32),
        scratch_shapes=[pltpu.VMEM((m, c), jnp.int32)], interpret=True)(jnp.asarray(x)))


def _scratch_pallas(script, x):
    m, c = x.shape
    return np.asarray(pl.pallas_call(
        script.scratch_kernel, out_shape=jax.ShapeDtypeStruct((m, c), jnp.int8),
        scratch_shapes=[pltpu.VMEM((m + 4, c), jnp.int8)], interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("data", ["script", "random"])
def test_shift_matches_pallas(script, data):
    m, c = 1056, 320
    if data == "script":
        x = (np.arange(m * c, dtype=np.int32) % 7).reshape(m, c)
    else:
        x = np.random.RandomState(1).randint(-(1 << 20), 1 << 20, (m, c)).astype(np.int32)
    ref = _shift_pallas(script, x)
    np.testing.assert_array_equal(probe_shift(torch.from_numpy(x)).numpy(), ref)
    # edge rows: row 0 has only the +1 and +66 neighbours, the last row -1 and -66
    np.testing.assert_array_equal(ref[0], x[1] + x[66])
    np.testing.assert_array_equal(ref[-1], x[-2] + x[-67])


@pytest.mark.parametrize("data", ["script", "random"])
def test_scratch_matches_pallas(script, data):
    m, c = 512, 320
    if data == "script":
        x = (np.arange(m * c, dtype=np.int32) % 5).reshape(m, c)
        x = jnp.asarray(x).astype(jnp.bfloat16)
    else:   # inside [-127, 127], where the cast is a plain truncation
        x = jnp.asarray(np.random.RandomState(2).uniform(-127, 127, (m, c)), jnp.bfloat16)
    ref = _scratch_pallas(script, x)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    out = probe_scratch(xt).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[0] == 0).all()
    if data == "random":
        assert (np.asarray(x[0], np.float32) != np.trunc(np.asarray(x[0], np.float32))).any()


def test_s8_convert_truncates_toward_zero():
    x = torch.tensor([42.5, -32.25, 0.99, -0.99, 127.0, -128.0]).to(torch.bfloat16)
    ref = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16).astype(jnp.int8))
    np.testing.assert_array_equal(s8_convert(x).numpy(), ref)
    np.testing.assert_array_equal(ref, [42, -32, 0, 0, 127, -128])
    out = probe_scratch_plain(x.reshape(2, 3))
    np.testing.assert_array_equal(out.numpy(), [[0, 0, 0], [42, -32, 0]])


def test_probes_entry_point_on_cpu():
    results = probes.main("cpu")
    assert [r["probe"] for r in results] == ["int8_mm", "shift", "scratch"]
    assert all(r["ok"] and r["ms"] is None for r in results)


def test_wrappers_refuse_other_devices():
    meta = lambda dtype: torch.empty((32, 32), dtype=dtype, device="meta")
    for fn, args in ((probe_shift, (meta(torch.int32),)),
                     (probe_scratch, (meta(torch.bfloat16),)),
                     (probe_s8mm, (meta(torch.int8), meta(torch.int8)))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args)

"""The utilities, port against the JAX package on the same arrays:
``utils/units.py`` (every unit name, the parameter totals),
``utils/debug.py`` (``assert_all_finite``, ``checked`` raising and passing
where checkify's float checks do), ``utils/profiling.py`` (the meters, a
trace written on the CPU and its summary) and the one-process
``MetricAccumulator``."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.utils import debug as jdebug
from vdtpu.utils import logging as jlogging
from vdtpu.utils import units as junits
from vdtpu_torch.utils import debug, profiling, units
from vdtpu_torch.utils.logging import MetricAccumulator

torch.set_num_threads(2)

UNITS = [None, "none", "identity", "relu", "silu", "swish", "gelu", "sigmoid", "tanh", "sine",
         "lrelu0.2", "lrelu0.01", "elu", "elu0.5"]


@pytest.mark.parametrize("name", UNITS)
def test_get_unit_matches_vdtpu(name):
    x = np.random.RandomState(0).randn(64).astype(np.float32) * 3
    ours = units.get_unit(name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(junits.get_unit(name)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_unknown_unit_raises_on_both_sides():
    for get in (units.get_unit, junits.get_unit):
        with pytest.raises(KeyError):
            get("nope")


def test_parameter_totals_match_vdtpu():
    rs = np.random.RandomState(1)
    tree = {"a": rs.randn(2, 3).astype(np.float32),
            "b": {"c": rs.randn(4).astype(np.float32), "d": rs.randn(5, 5).astype(np.float32)}}
    ours = {"a": torch.from_numpy(tree["a"]),
            "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}}
    jtree = {"a": jnp.asarray(tree["a"]), "b": {k: jnp.asarray(v) for k, v in tree["b"].items()}}
    assert units.get_total_param(ours) == junits.get_total_param(jtree) == 35
    np.testing.assert_allclose(units.get_total_param_sum(ours),
                               junits.get_total_param_sum(jtree), rtol=1e-6)
    lin = torch.nn.Linear(3, 4)
    assert units.get_total_param(lin) == 16
    want = float(lin.weight.detach().sum() + lin.bias.detach().sum())
    np.testing.assert_allclose(units.get_total_param_sum(lin), want, rtol=1e-6)


def test_assert_all_finite_matches_vdtpu():
    good = {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.float32)]}
    bad = {"a": np.ones(3, np.float32), "b": {"c": np.array([1.0, np.inf], np.float32)}}
    debug.assert_all_finite({k: torch.as_tensor(np.asarray(v[0] if isinstance(v, list) else v))
                             for k, v in good.items()}, "ok")
    jdebug.assert_all_finite({"a": jnp.ones(3)}, "ok")
    with pytest.raises(FloatingPointError, match=r"non-finite values in bad: \['b/c'\]"):
        debug.assert_all_finite({"a": torch.ones(3), "b": {"c": torch.tensor(bad["b"]["c"])}},
                                "bad")
    with pytest.raises(FloatingPointError, match="non-finite values in bad"):
        jdebug.assert_all_finite({"a": jnp.ones(3), "b": {"c": jnp.asarray(bad["b"]["c"])}},
                                 "bad")


CHECKED = [("log of -1", lambda m: m.log, -1.0, True),
           ("0 / 0", lambda m: (lambda x: x / x), 0.0, True),
           ("1 / 0", lambda m: (lambda x: 1.0 / x), 0.0, True),
           ("inf - inf", lambda m: (lambda x: x - x), np.inf, True),
           ("clean", lambda m: (lambda x: x * 2 + 1), 1.5, False),
           ("log of 2", lambda m: m.log, 2.0, False)]


@pytest.mark.parametrize("label,fn,value,raises", CHECKED, ids=[c[0] for c in CHECKED])
def test_checked_raises_where_vdtpu_does(label, fn, value, raises):
    """Both sides raise on the same calls (checkify raises its runtime
    error, the port ``FloatingPointError``) and return the same value on
    the clean ones."""
    x = np.array([value, 1.0], np.float32)
    try:
        jout = np.asarray(jdebug.checked(fn(jnp))(jnp.asarray(x)))
        jraised = False
    except Exception:
        jraised = True
    assert jraised == raises, label
    f = debug.checked(fn(torch))
    if raises:
        with pytest.raises(FloatingPointError):
            f(torch.from_numpy(x))
    else:
        np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(), jout, rtol=1e-6)


def test_debug_nan_hook_prints_only_when_not_finite(capsys):
    x = torch.tensor([1.0, float("nan"), float("inf")])
    assert debug.debug_nan_hook(x, "probe") is x
    assert "NaN/Inf in probe: 2 elements" in capsys.readouterr().out
    debug.debug_nan_hook(torch.ones(2), "clean")
    assert capsys.readouterr().out == ""


def test_throughput_meter_and_timer():
    for meter in (profiling.ThroughputMeter(), jprof_meter()):
        meter.update(4)
        meter.update(4)
        r = meter.rates()
        assert r["units_per_sec"] > 0 and r["steps_per_sec"] > 0 and r["window_sec"] > 0
        assert r["units_per_sec"] == pytest.approx(4 * r["steps_per_sec"])
    t = profiling.Timer()
    time.sleep(0.02)
    assert 0.02 <= t.stop(torch.ones(2)) < 5


def jprof_meter():
    from vdtpu.utils.profiling import ThroughputMeter
    return ThroughputMeter()


def test_trace_and_summarize_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace; ``summarize_trace`` finds no device
    event on the CPU and sums the host operators by class."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("two products"):
            for _ in range(2):
                (a @ a).relu_()
    assert prof is not None and (tmp_path / profiling.TRACE_FILE).exists()
    assert profiling.summarize_trace(str(tmp_path)) == {}
    host = profiling.summarize_trace(str(tmp_path), top=None, device=False)
    assert host["aten::mm"] > 0 and "aten::relu_" in host
    assert profiling.summarize_trace(str(tmp_path), top=1, device=False).keys() <= host.keys()
    assert profiling.device_memory_stats() == {}
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "nothing"))


def test_metric_accumulator_matches_vdtpu_in_one_process():
    ours, ref = MetricAccumulator(), jlogging.MetricAccumulator()
    for m in (ours, ref):
        m.accumulate({"loss": 1.0, "x": 2.0}, weight=1)
        m.accumulate({"loss": 3.0}, weight=3)
    assert ours.means() == pytest.approx(ref.means())
    assert ours.summary() == ref.summary()

"""Calibrated int8 serving policy (``vdtpu/ops/quant.py``).

Weights are quantized per output channel, symmetric, to int8; activations
per tensor with a static scale recorded by a calibration pass (or the
dynamic absmax where a site has none); products accumulate exactly in
int32 and the rescale (s_x * s_w), bias and an optional fused add run in
f32 before the cast to the compute dtype.

The JAX package switches this on with process-global state read at trace
time (``set_policy``, ``VDTPU_QCONV_GN``, ``VDTPU_QCONV``,
``VDTPU_INT8_MIN_PIXELS``, ``VDTPU_INT8_CLIP``, ``set_site_filter``). Here
the same choices are one frozen ``QuantPolicy`` that ``VDSystem`` hands to
every call site (``set_quant_policy``); with no policy a site is the plain
layer it replaces. A site's int8 state (``act_scale``, ``w_q``,
``w_scale``, and ``attn_shift`` on attention owners) lives in
non-persistent buffers, so checkpoints load with ``strict=True`` either
way, and the buffers keep their dtype when the module is cast.

Call sites: ``QConv`` (3x3 convs, through the int8 conv kernel of
``ops/qconv.py`` on CUDA) and ``QDense`` (linear maps, through
``torch._int_mm`` on CUDA, as the JAX package leaves its int8 dot to XLA).
``fused_proj`` shares one activation quantize across an attention's q/k/v
projections. On CPU tensors every product runs in plain PyTorch with exact
integer accumulation.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdtpu_torch.ops.gn_silu import gn_apply, gn_silu_q, gn_stats
from vdtpu_torch.ops.qconv import qconv3, qconv3_gn, resblock_q


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """The int8 serving policy of one system (defaults: the JAX defaults).

    gn_prologue: how a ResBlock conv's GroupNorm+SiLU meets its quantize:
      "plain" (GN+SiLU kernel, then quantize), "fused" (the GN+SiLU+int8
      kernel), "stats" (the GN statistics kernel, the apply and quantize in
      plain ops). ``VDTPU_QCONV_GN`` = 0 / 1 / stats.
    conv: "per_site", "fused" (ResBlock convs run GN+SiLU+quantize inside
      the conv kernel; ``VDTPU_QCONV=fused``) or "fused2" (a ResBlock's
      GN1+SiLU+quantize, conv1, FiLM, GN2+SiLU+quantize, conv2 and skip add
      in one kernel, ``ops/qconv.py::resblock_q``; ``VDTPU_QCONV=fused2``).
      fused2 takes a site that "fused" takes and whose two convs both have
      calibrated tables and run int8; every other ResBlock of a fused2
      policy runs as under "fused".
    min_pixels: conv sites whose input has fewer pixels run in the compute
      dtype with the same parameters (``VDTPU_INT8_MIN_PIXELS``).
    fused_min_pixels: the smallest map ``conv="fused"`` takes
      (``VDTPU_QCONV_MIN_PIXELS``).
    clip: calibration statistic: None (absmax), "q<p>" (|x| quantile p %),
      "sigma<k>" (min(absmax, k * rms)) (``VDTPU_INT8_CLIP``).
    skip_sites: comma-separated ``pattern[@cin]`` entries naming sites that
      run in the compute dtype: ``pattern`` is a substring of the site's
      module path (e.g. ``in_layers.2``, ``qkv``, ``to_out.0``,
      ``ff.net``), ``@cin`` restricts it to one input width; a leading
      "-" is cosmetic (``set_site_filter``). Calibration ignores it.
    """
    gn_prologue: str = "plain"
    conv: str = "per_site"
    min_pixels: int = 256
    fused_min_pixels: int = 1024
    clip: str | None = None
    skip_sites: str = ""

    def __post_init__(self):
        if self.gn_prologue not in ("plain", "fused", "stats"):
            raise ValueError(f"gn_prologue must be plain, fused or stats: {self.gn_prologue!r}")
        if self.conv not in ("per_site", "fused", "fused2"):
            raise ValueError(f"conv must be per_site, fused or fused2: {self.conv!r}")
        if self.clip is not None:
            num = (self.clip[5:] if self.clip.startswith("sigma")
                   else self.clip[1:] if self.clip.startswith("q") else "")
            if not _is_float(num):
                raise ValueError(f"clip must be None, 'q<p>' or 'sigma<k>': {self.clip!r}")

    def site_enabled(self, path: str, cin: int) -> bool:
        """True when the site at module ``path`` with ``cin`` inputs runs int8."""
        for ent in self.skip_sites.split(","):
            pat, _, ch = ent.strip().lstrip("-").partition("@")
            if pat and pat in path and (ch in ("", "*") or int(ch) == cin):
                return False
        return True


def _is_float(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return True


def quantize_weight(w):
    """Symmetric per-output-channel int8 of a [N, ...] weight:
    (int8 codes of w's shape, f32 scales [N])."""
    wf = w.float()
    s = wf.abs().amax(dim=tuple(range(1, wf.dim())), keepdim=True)
    s = torch.clamp(s / 127.0, min=1e-10)
    wq = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return wq, s.reshape(-1)


def quantize_act(x, s=None):
    """Symmetric per-tensor int8: divide by the scale, round half to even,
    clip to +-127. ``s`` None takes the dynamic absmax. Returns (codes, s)."""
    xf = x.float()
    if s is None:
        s = torch.clamp(xf.abs().amax() / 127.0, min=1e-10)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _quantile(v, q: float):
    """Linear-interpolation quantile of a flat tensor (jnp.quantile's rule),
    through a sort, so any size works."""
    v = v.sort().values
    pos = q * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def calib_stat(x, clip: str | None = None):
    """The activation statistic a site records during calibration."""
    ax = x.float().abs()
    if clip is not None and clip.startswith("q"):
        return _quantile(ax.reshape(-1), float(clip[1:]) / 100.0)
    if clip is not None and clip.startswith("sigma"):
        rms = torch.sqrt(torch.mean(ax * ax))
        return torch.minimum(ax.amax(), float(clip[5:]) * rms)
    return ax.amax()


def int8_linear(xq, w_q, s_x, w_scale, bias=None, add=None, out_dtype=torch.float32):
    """(xq @ w_q^T) * (s_x * w_scale) + bias + add over the last axis.

    xq int8 [..., K]; w_q int8 [N, K]; s_x f32 scalar; w_scale f32 [N].
    The product is exact: int32 on the CPU, ``torch._int_mm`` (s8 x s8 ->
    s32, cuBLAS) on CUDA. ``torch._int_mm`` takes more than 16 rows only:
    a product of fewer rows (a 0-D flow's [B, F] input) runs on its rows
    zero-padded (``pad_rows``) and sliced back, which is exact (a zero row
    adds nothing). K and N must be multiples of 8, else it raises."""
    k, n = xq.shape[-1], w_q.shape[0]
    x2 = xq.reshape(-1, k)
    if xq.device.type == "cpu":
        acc = x2.to(torch.int32) @ w_q.to(torch.int32).t()
    elif xq.device.type == "cuda":
        if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
            raise TypeError(f"int8_linear takes int8 operands, got {xq.dtype}/{w_q.dtype}")
        if not (k % 8 == 0 and n % 8 == 0):
            raise ValueError(f"int8_linear: torch._int_mm needs K, N multiples of 8; got "
                             f"[{x2.shape[0]}, {k}] x [{k}, {n}]")
        m = x2.shape[0]
        acc = torch._int_mm(pad_rows(x2.contiguous()), w_q.t())[:m]
        int8_linear.launches += 1
    else:
        raise ValueError(f"int8_linear: no path for device {xq.device}")
    y = acc.float() * (s_x * w_scale)
    if bias is not None:
        y = y + bias.float()
    y = y.reshape(*xq.shape[:-1], n)
    if add is not None:
        y = y + add.float()
    return y.to(out_dtype)


int8_linear.launches = 0


def pad_rows(x2):
    """x2 [m, K] as ``torch._int_mm`` takes it: unchanged for m > 16, else
    with zero rows appended up to 24 (the next multiple of 8 above 16)."""
    m = x2.shape[0]
    if m > 16:
        return x2
    return torch.cat([x2, x2.new_zeros((24 - m, x2.shape[1]))])


class QuantState:
    """Mixin for a module that owns int8 state: the policy, its site path,
    the calibration record and the quant buffers. ``calib`` is a dict while
    a calibration pass runs (statistic key -> running max), else None."""

    QUANT_BUFFERS: tuple[str, ...] = ()

    def init_quant(self):
        self.policy: QuantPolicy | None = None
        self.site = ""
        self.calib: dict | None = None
        for name in self.QUANT_BUFFERS:
            self.register_buffer(name, None, persistent=False)

    def _apply(self, fn, recurse=True):
        # keep the quant buffers' own dtypes (f32 scales, int8 codes) when the
        # module is cast; they follow its device
        held = {k: self._buffers[k] for k in self.QUANT_BUFFERS if self._buffers[k] is not None}
        for k in held:
            self._buffers[k] = None
        super()._apply(fn, recurse)
        if held:
            dev = next(self.parameters()).device
            for k, v in held.items():
                self._buffers[k] = v.to(dev)
        return self

    def int8_active(self, cin: int, suffix: str = "") -> bool:
        pol = self.policy
        return pol is not None and (self.calib is not None or pol.site_enabled(self.site + suffix,
                                                                               cin))

    def attach_tables(self) -> None:
        """After calibration: materialize the weight tables of a site that
        recorded a scale."""
        if self.act_scale is not None:
            self.w_q, self.w_scale = (t.contiguous() for t in self.tables())

    def record(self, key: str, stat):
        prev = self.calib.get(key)
        self.calib[key] = stat if prev is None else torch.maximum(prev, stat)

    def quantize_input(self, x, suffix: str = ""):
        """(codes, scale) of x: records the statistic while calibrating (and
        quantizes with the dynamic scale, as the JAX calibration pass does),
        else uses the site's static scale, or the dynamic one if it has none."""
        if self.calib is not None:
            self.record("act" + suffix, calib_stat(x, self.policy.clip))
            return quantize_act(x)
        return quantize_act(x, getattr(self, "act_scale" + suffix))


class QDense(QuantState, nn.Linear):
    """Linear layer that runs int8 under a policy; same parameters as nn.Linear."""

    QUANT_BUFFERS = ("act_scale", "w_q", "w_scale")

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.init_quant()

    def weight2d(self):
        return self.weight

    def tables(self):
        """(w_q [N, K], w_scale [N]): the calibrated tables, or made now."""
        if self.w_q is not None:
            return self.w_q, self.w_scale
        wq, ws = quantize_weight(self.weight2d())
        return wq.reshape(wq.shape[0], -1), ws

    def linear(self, x):
        """The exact projection (a tensor-parallel layer gathers its output
        features here, ``parallel/mesh.py``)."""
        return F.linear(x, self.weight2d(), self.bias)

    def forward(self, x, add=None):
        if not self.int8_active(x.shape[-1]):
            y = self.linear(x)
            return y if add is None else y + add
        xq, s_x = self.quantize_input(x)
        return self.matmul_q(xq, s_x, add, x.dtype)

    def matmul_q(self, xq, s_x, add=None, out_dtype=torch.float32):
        w_q, w_s = self.tables()
        return int8_linear(xq, w_q, s_x, w_s, self.bias, add, out_dtype)


def split_add(add):
    """An epilogue add as (FiLM vector [B, N] or None, full [B, N, H, W] or None)."""
    if add is None:
        return None, None
    if add.shape[2:] == (1, 1):
        return add[:, :, 0, 0], None
    return None, add


class QConv(QuantState, nn.Conv2d):
    """3x3 conv (padding 1) that runs int8 under a policy; same parameters as
    nn.Conv2d. ``w_q`` is [N, 3, 3, C] (channels last, the conv kernel's K)."""

    QUANT_BUFFERS = ("act_scale", "w_q", "w_scale")

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=1)
        self.init_quant()

    def tables(self):
        if self.w_q is not None:
            return self.w_q, self.w_scale
        wq, ws = quantize_weight(self.weight)
        return wq.permute(0, 2, 3, 1).contiguous(), ws

    def conv(self, x):
        """The exact convolution (a tensor-parallel layer gathers its output
        channels here, ``parallel/mesh.py``)."""
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)

    def forward(self, x, gn=None, add=None, fused: bool = False):
        """x NCHW. gn: the GroupNorm32 whose GN+SiLU precedes this conv (run
        as the policy's prologue) or None. add: FiLM [B, N, 1, 1] or a full
        residual, summed in the f32 epilogue under int8. fused: the ResBlock
        chose ``conv="fused"`` for this site."""
        pol = self.policy
        b, c, h, w = x.shape
        if pol is None or h * w < pol.min_pixels or not self.int8_active(c):
            hx = x if gn is None else gn(x, silu=True)
            y = self.conv(hx)
            return y if add is None else y + add
        w_q, w_s = self.tables()
        add_vec, add_full = split_add(add)
        static = self.calib is None and self.act_scale is not None
        if gn is not None:  # the GN kernels read groups as contiguous runs
            x = x.contiguous()
        stride = self.stride[0]
        if fused and static:
            st = gn_stats(x, gn.groups, gn.eps)
            return qconv3_gn(x, st, gn.weight, gn.bias, self.act_scale, w_q, w_s, self.bias,
                             True, stride, add_vec, add_full)
        if gn is not None and static and pol.gn_prologue == "fused":
            xq = gn_silu_q(x, gn.weight, gn.bias, self.act_scale, gn.groups, gn.eps, True)
            s_x = self.act_scale
        else:
            if gn is not None and pol.gn_prologue == "stats":
                # the JAX "stats" prologue: statistics from the kernel, the
                # apply in plain ops, rounded to the compute dtype
                st = gn_stats(x, gn.groups, gn.eps)
                hx = gn_apply(x, st, gn.weight, gn.bias).to(x.dtype)
            elif gn is not None:
                hx = gn(x, silu=True)
            else:
                hx = x
            xq, s_x = self.quantize_input(hx)
            xq = xq.permute(0, 2, 3, 1).contiguous()
        return qconv3(xq, w_q, w_s, self.bias, s_x, stride, add_vec, add_full, x.dtype)


def fused2_ready(conv1: QConv, conv2: QConv, cin: int, pixels: int) -> bool:
    """Both convs of a ResBlock run int8 from calibrated tables, so the
    whole-ResBlock kernel may take it (vdtpu's ``has_tables()`` on both;
    a calibration pass always runs the per-conv path)."""
    return (pixels >= conv1.policy.min_pixels
            and all(c.calib is None and c.act_scale is not None for c in (conv1, conv2))
            and conv1.int8_active(cin) and conv2.int8_active(conv2.in_channels))


def resblock_int8(x, gn1, conv1, film, gn2, conv2, skip):
    """A ResBlock's two int8 convs with their GroupNorm+SiLU prologues, the
    FiLM vector [B, N] and the skip (None: identity) in one
    ``resblock_q`` call; x NCHW, result NCHW in x's dtype."""
    if (gn1.groups, gn1.eps) != (gn2.groups, gn2.eps):
        raise ValueError("resblock_int8: the two GroupNorms differ in groups or eps")
    w1q, s1w = conv1.tables()
    w2q, s2w = conv2.tables()
    return resblock_q(x.contiguous(), gn1.weight, gn1.bias, w1q, s1w, conv1.bias,
                      conv1.act_scale, film, gn2.weight, gn2.bias, w2q, s2w, conv2.bias,
                      conv2.act_scale, skip, gn1.groups, gn1.eps)


def fused_proj(owner: QuantState, x, denses, suffix: str = ""):
    """Project x through several QDense layers sharing one activation
    quantize (the owner holds ``act_scale`` + suffix; each layer its own
    weight table). Numerically identical to separate int8 calls."""
    if not owner.int8_active(x.shape[-1], ".qkv" + suffix):
        return [d.linear(x) for d in denses]
    xq, s_x = owner.quantize_input(x, suffix)
    return [d.matmul_q(xq, s_x, None, x.dtype) for d in denses]


def set_quant_policy(module: nn.Module, policy: QuantPolicy | None) -> None:
    """Attach the policy to every int8 site under ``module`` (None: plain)."""
    for name, m in module.named_modules():
        if isinstance(m, QuantState):
            m.policy, m.site = policy, name


def quant_sites(module: nn.Module):
    return [(name, m) for name, m in module.named_modules() if isinstance(m, QuantState)]


@torch.no_grad()
def calibrate(module: nn.Module, run_probes) -> dict[str, torch.Tensor]:
    """Record every site's statistics while ``run_probes()`` drives the
    model (each site keeps the max over the probes, as the flax ``sow``
    with ``jnp.maximum`` does), then set the scales, the attention shifts
    and the weight tables. Sites need a policy (``set_quant_policy``).
    Returns the new quant state (``quant_state``)."""
    sites = quant_sites(module)
    if any(m.policy is None for _, m in sites):
        raise RuntimeError("calibrate() needs an int8 policy on every site")
    for _, m in sites:
        m.calib = {}
    try:
        run_probes()
        records = [(m, m.calib) for _, m in sites]
    finally:
        for _, m in sites:
            m.calib = None
    for m, rec in records:
        for key, stat in rec.items():
            if key.startswith("act"):
                setattr(m, "act_scale" + key[3:], torch.clamp(stat / 127.0, min=1e-10).float())
            elif key == "logit_max":
                m.attn_shift = stat.float()
        m.attach_tables()
    return quant_state(module)


def quant_state(module: nn.Module) -> dict[str, torch.Tensor]:
    """{site path + "." + buffer name: tensor} of every quant buffer set."""
    out = {}
    for name, m in quant_sites(module):
        for key in m.QUANT_BUFFERS:
            v = getattr(m, key)
            if v is not None:
                out[f"{name}.{key}" if name else key] = v
    return out


def load_quant_state(module: nn.Module, state) -> None:
    """Set quant buffers from ``quant_state``-keyed tensors or numpy arrays."""
    sites = dict(quant_sites(module))
    dev = next(module.parameters()).device
    for key, v in state.items():
        name, _, buf = key.rpartition(".")
        m = sites.get(name)
        if m is None or buf not in m.QUANT_BUFFERS:
            raise KeyError(f"no quant buffer {key!r}")
        setattr(m, buf, (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(dev))

"""GroupNorm(+SiLU): a hand-written CUDA C++ kernel and its plain version;
the int8 policy's GroupNorm kernels (Triton).

Counterpart of ``vdtpu/ops/pallas/gn_silu.py::gn_silu`` (its ``_kernel``,
reached through ``_fused_impl``). Both compute, per sample and group, f32
statistics as E[x^2] - E[x]^2 (clipped at 0, as flax's GroupNorm does),
then normalize, apply the per-channel affine and an optional SiLU, and cast
back to the input dtype. Layout here is channel-first, [B, C, *spatial]
contiguous, where a run of whole groups of one sample is one contiguous
range of memory.

Kernel: ``csrc/gn_silu.cu``, one launch a call (its source note has the
design). A cluster of k CTAs owns a band of whole groups of one sample;
each CTA copies its share into shared memory, sums x and x^2 per group, the
cluster combines the partials through distributed shared memory in a fixed
order (the same bits run to run), and each CTA normalizes from shared
memory: x is read once and y written once ("resident" route). Where the
resident CTAs would not fit the card at once (the VAE's maps from 128^2 on,
the 960-channel 64^2 UNet site) x takes the "streaming" route: persistent
clusters walk the bands, each band's statistics from a pass over global
memory, the same combine, then a second pass that normalizes. ``gn_plan`` picks the route, the cluster, the band,
the pixels a CTA and the shared memory, and raises on what the kernel does
not take; the C entry point recomputes the shared memory and refuses a plan
that does not match. Bound on this card: one read and one write of x at
3.35 TB/s. The wrapper's host cost is the checks, one allocation and one
ctypes call with the launch's arguments built once a distinct call.

The int8 serving policy adds two Triton kernels on a split reduction over a
(B*G, S) grid (kernel K2 of the port):
  - ``gn_stats``: a stats pass of partial sums, then a finalize pass that
    writes [B, 2, C] f32 channel-broadcast (mean, rstd). Replaces
    ``vdtpu/ops/pallas/gn_silu.py::gn_stats`` (its ``_stats_kernel``).
  - ``gn_silu_q``: the stats pass, then an apply pass that normalizes,
    applies the affine and SiLU and quantizes to int8 with the static
    activation scale, clip(round half to even(y * (1 / s)), -127, 127): the
    multiply by the reciprocal of ``_kernel_q`` / ``_apply_q_kernel``, not
    ``_quantize_act``'s divide (codes can differ by one at rounding
    boundaries; ROADMAP queue 3). Replaces ``gn_silu_q`` (``_kernel_q``)
    and ``_gn_silu_q_blocked`` (``_stats_kernel`` + ``_apply_q_kernel``),
    whose two-pass design this already is.
The apply pass is where the layout changes: it reads x channel-first
(groups contiguous, as the statistics want) and stores the s8 codes
channels-last, [B, *spatial, C], which is what the int8 conv kernel
(``ops/qconv.py``) reads as its implicit-GEMM K axis. Each program takes a
[64 channels x 64 pixels] block, so both its loads (along pixels) and its
s8 stores (along channels) are contiguous runs; moving the layout here
costs no extra pass, where a separate transpose would read and write the
codes once more. Bound: one read of x and one s8 write, at [4, 320, 64,
64] 10.5 + 5.2 MB, about 0.0047 ms at 3.35 TB/s (the stats pass's
re-read mostly hits L2). The int8 variant on the CUDA kernel's template
(bands of lcm(C / G, 16) channels, so that a pixel's codes are whole
16-byte runs) was built and measured slower than this one: ROADMAP.

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. ``gn_silu`` is differentiable
(``GNSiLU``): its backward recomputes the plain version and differentiates
it, as the JAX package's custom_vjp does; a backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from vdtpu_torch.ops.kernels.build import load

_BLOCK = 1024
_TARGET_PROGRAMS = 132 * 8
_MAX_SPLIT = 64
_QBLOCK = 64  # channels a program of gn_stats' finalize pass

NUM_SMS = 132                # the plan's default: an H100 SXM
GN_MAX_SMEM = 232_448        # dynamic shared memory a CTA can have (227 KB)
GN_SM_SMEM = 233_472         # shared memory an SM holds for its CTAs (228 KB)
GN_SMEM_BUDGET = 200 * 1024  # a resident CTA's share of x, at most
# clusters of k CTAs (at most 16; above 8 a non-portable cluster) an H100
# 80GB HBM3 holds at once at one CTA an SM
# (cudaOccupancyMaxActiveClusters through csrc/gn_silu.cu::vd_gn_max_clusters;
# a cluster's CTAs share one GPC, and GPCs differ in SMs): clusters of 4 or 8
# use 120 of the 132 SMs, clusters of 16 use 112
GN_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
GN_PACK_BYTES = 8192         # small groups share a CTA up to this band size
# the resident plan's cost terms, from cluster-size sweeps at the UNet's and
# the VAE's sites (PERF.md): a CTA's fixed time and a cluster's barriers, in
# bytes of x an SM would move meanwhile
GN_CTA_BYTES = 32 * 1024
GN_CLUSTER_BYTES = 16 * 1024
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def gn_stats_plain(x, groups: int = 32, eps: float = 1e-5):
    """[B, C, *spatial] -> [B, 2, C] f32: each channel's group (mean, rstd),
    E[x^2] - E[x]^2 clipped at 0, in plain PyTorch."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = ((xf * xf).mean(dim=-1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return torch.stack([mean, rstd], dim=1).repeat_interleave(c // groups, dim=2)


def gn_apply(x, stats, weight, bias, with_silu: bool = True):
    """GroupNorm(+SiLU) of [B, C, *spatial] from its [B, 2, C] statistics
    and the per-channel affine, in f32 (the result stays f32)."""
    shape = x.shape[:2] + (1,) * (x.dim() - 2)
    y = (x.float() - stats[:, 0].reshape(shape)) * stats[:, 1].reshape(shape)
    y = y * weight.float().reshape(shape[1:]) + bias.float().reshape(shape[1:])
    return y * torch.sigmoid(y) if with_silu else y


def gn_silu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                  with_silu: bool = True):
    """GroupNorm(+SiLU) over [B, C, *spatial] in plain PyTorch (f32 math)."""
    st = gn_stats_plain(x, groups, eps)
    return gn_apply(x, st, weight, bias, with_silu).to(x.dtype)


def gn_silu_q_plain(x, weight, bias, s_act, groups: int = 32, eps: float = 1e-5,
                    with_silu: bool = True):
    """GroupNorm(+SiLU) then int8 codes with the static scale ``s_act``,
    clip(round(y * (1 / s_act)), -127, 127) (torch.round: half to even, as
    jnp.round); [B, C, *spatial] in, channels-last [B, *spatial, C] int8 out."""
    y = gn_apply(x, gn_stats_plain(x, groups, eps), weight, bias, with_silu)
    inv = 1.0 / torch.as_tensor(s_act, dtype=torch.float32, device=x.device)
    q = torch.round(y * inv).clamp(-127, 127).to(torch.int8)
    return q.movedim(1, -1).contiguous()


def split_count(bg: int, group_len: int) -> int:
    """gn_stats' programs per group: enough to fill the card, each with >= one block."""
    s = 1
    while (s * 2 <= _MAX_SPLIT and bg * s < _TARGET_PROGRAMS
           and group_len >= s * 2 * _BLOCK):
        s *= 2
    return s


# ---- the CUDA kernel's plan ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNPlan:
    """Geometry of one ``csrc/gn_silu.cu`` launch. ``route`` "resident" (a
    CTA holds its share of x in shared memory: one read, one write) or
    "streaming" (statistics from one pass over global memory, a second pass
    normalizes); ``layout`` "rows" (a CTA takes ``pixels`` pixels of every
    channel of its band, each row a 16-byte aligned run) or "flat" (k = 1,
    the band one contiguous range of any alignment). A cluster of
    ``cluster`` CTAs owns a band of ``groups_per_band`` groups of one
    sample; there are ``bands`` bands (B * G / groups_per_band). The launch
    has ``clusters`` clusters (one a band on the resident route; on the
    streaming route fewer, each walking the bands ``clusters`` apart) of
    CTAs of ``threads`` threads and ``smem_bytes`` shared memory."""
    route: str
    layout: str
    cluster: int
    groups_per_band: int
    bands: int
    pixels: int
    threads: int
    smem_bytes: int
    clusters: int

    @property
    def ctas(self) -> int:
        return self.clusters * self.cluster


def _gn_threads(elems: int, vec: int) -> int:
    vectors = elems // vec
    return 512 if vectors >= 2048 else 256 if vectors >= 512 else 128


def gn_smem_bytes(route: str, layout: str, threads: int, gpb: int, bandc: int, pixels: int,
                  hw: int, es: int) -> int:
    """Shared memory of a launch, as csrc/gn_silu.cu::layout lays it out: the
    reduction teams' partials, the CTA's partials, the per-channel table,
    then the tile of x (resident route; the flat range with room to keep
    its address modulo 16)."""
    nwarps = threads // 32
    wpt = nwarps // gpb if gpb <= nwarps else 1
    aux = 8 * gpb * wpt + 8 * gpb + 12 * bandc
    tile = 0
    if route == "resident":
        tile = bandc * pixels * es if layout == "rows" else -(-(bandc * hw * es + 16) // 16) * 16
    return -(-aux // 128) * 128 + tile


@functools.lru_cache(maxsize=512)
def gn_plan(shape: tuple, dtype: torch.dtype, groups: int, aligned: bool = True,
            sms: int = NUM_SMS) -> GNPlan:
    """The GN kernel's plan for a contiguous x of ``shape`` [B, C, *spatial]
    (``aligned``: x starts on a 16-byte boundary): the resident route where
    all of its CTAs fit the card at once (one wave), else the streaming
    route (``gn_variant`` gives the others, for measuring them).

    - The band: 1 group; bands of small groups are doubled while they stay
      within GN_PACK_BYTES and B * G / band still fills ``sms`` CTAs.
    - The rows layout needs x aligned and rows of whole 16-byte vectors
      (HW * itemsize % 16 == 0); a cluster of k > 1 also needs HW % k == 0
      and pixels a CTA in whole vectors. Otherwise k = 1, flat layout.
    - Resident: of the cluster sizes that give one wave (``one_wave``),
      the one of least ``cost``, the smaller on a tie. (A CTA's load and
      apply cannot overlap, so a second wave of resident CTAs leaves the
      card's memory idle half the time: at the VAE's sites the streaming
      route is as fast or faster, PERF.md.)
    - Streaming: rows layout only; persistent clusters (``stream_clusters``)
      walk the bands; the cluster size whose busiest CTA reads the fewest
      bytes, the smaller on a tie (the route's time follows the CTAs in
      flight, not L2 reuse: PERF.md)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"gn kernel: unsupported dtype {dtype}")
    b, c = shape[0], shape[1]
    hw = math.prod(shape[2:])
    if b < 1 or hw < 1 or groups < 1 or c % groups:
        raise ValueError(f"gn_plan: {groups} groups do not divide shape {tuple(shape)}")
    es = torch.empty((), dtype=dtype).element_size()
    vec = 16 // es
    cpg = c // groups
    rows_ok = aligned and (hw * es) % 16 == 0
    gpb = 1
    while (groups % (2 * gpb) == 0 and b * groups // (2 * gpb) >= sms
           and 2 * gpb * cpg * hw * es <= GN_PACK_BYTES):
        gpb *= 2
    bandc = gpb * cpg
    bands = b * groups // gpb
    layout = "rows" if rows_ok else "flat"
    ks = [k for k in (1, 2, 4, 8, 16)
          if k == 1 or (rows_ok and hw % k == 0 and (hw // k) % vec == 0)]

    def stream_clusters(k):
        """Streaming clusters of k: one a band, up to as many as the card
        holds at one CTA an SM."""
        return max(1, min(bands, GN_CLUSTERS[k] * sms // NUM_SMS))

    def plan(rt, k):
        px = hw // k
        threads = 512 if rt == "streaming" else _gn_threads(bandc * px, vec)
        smem = gn_smem_bytes(rt, layout, threads, gpb, bandc, px, hw, es)
        clusters = bands if rt == "resident" else stream_clusters(k)
        return GNPlan(rt, layout, k, gpb, bands, px, threads, smem, clusters)

    def one_wave(k):
        """Every CTA resident at once: the launch's CTAs within the SMs
        clusters of k use (GN_CLUSTERS[k] * k of an H100's 132) times the
        CTAs an SM holds, and the CTA's share within GN_SMEM_BUDGET."""
        pl = plan("resident", k)
        per_sm = min(GN_SM_SMEM // (pl.smem_bytes + 1024), 2048 // pl.threads)
        return (bandc * pl.pixels * es <= GN_SMEM_BUDGET and per_sm >= 1
                and bands * k <= GN_CLUSTERS[k] * k * sms // NUM_SMS * per_sm)

    def cost(k):
        """The busiest SM's CTAs times a CTA's share of x and GN_CTA_BYTES,
        plus GN_CLUSTER_BYTES for a cluster's barriers: bytes of x."""
        usable = max(1, GN_CLUSTERS[k] * k * sms // NUM_SMS)
        return (-(-bands * k // usable) * (bandc * (hw // k) * es + GN_CTA_BYTES)
                + (GN_CLUSTER_BYTES if k > 1 else 0))

    cands = [k for k in ks if one_wave(k)]
    if cands:
        return plan("resident", min(cands, key=lambda k: (cost(k), k)))
    if not rows_ok:
        raise ValueError(f"gn kernel: {tuple(shape)} {dtype} needs the streaming route, which "
                         f"takes 16-byte aligned x with rows of whole 16-byte vectors")
    # the busiest CTA's bytes: the bands its cluster walks times its share of
    # one (and a cluster's barriers, as in ``cost``)
    busiest = lambda k: -(-bands // stream_clusters(k)) * (
        bandc * (hw // k) * es + (GN_CLUSTER_BYTES if k > 1 else 0))
    return plan("streaming", min(ks, key=lambda k: (busiest(k), k)))


# ---- the kernel's order of work, on the CPU ---------------------------------

def _butterfly(v):
    """A warp's xor-shuffle sum of up to 32 lane values (zeros above them),
    as csrc/gn_silu.cu::warp_sum takes it: every lane ends with these bits."""
    v = torch.cat([v, torch.zeros(32 - v.numel(), dtype=v.dtype)])
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


def _team_sums(phases, tsz: int):
    """(sum, sum of squares) of one group's share as a reduction team of
    ``tsz`` threads takes it: ``phases`` is a list of [iters, tsz, width]
    f32 tensors (zeros where a thread has no item): each thread adds its
    items in order (x^2 by a fused multiply-add), then a butterfly in each
    warp, then one over the team's warp partials."""
    s = torch.zeros(tsz, dtype=torch.float32)
    ss = torch.zeros(tsz, dtype=torch.float32)
    for ph in phases:
        for it in range(ph.shape[0]):
            for j in range(ph.shape[2]):
                f = ph[it, :, j]
                s = s + f
                ss = (f.double() * f.double() + ss.double()).float()
    warps = [(_butterfly(s[w:w + 32]), _butterfly(ss[w:w + 32])) for w in range(0, tsz, 32)]
    return (_butterfly(torch.stack([w[0] for w in warps])),
            _butterfly(torch.stack([w[1] for w in warps])))


def _strided(items, tsz: int):
    """[n, width] items, thread t taking t, t + tsz, ... -> [iters, tsz, width]."""
    n, width = items.shape
    iters = -(-n // tsz)
    pad = torch.zeros((iters * tsz - n, width), dtype=items.dtype)
    return torch.cat([items, pad]).reshape(iters, tsz, width)


def gn_blocked_plain(x, weight, bias, groups: int, eps: float, with_silu: bool, plan: GNPlan):
    """``csrc/gn_silu.cu``'s order of work for ``plan`` on CPU tensors (x
    16-byte aligned): per band and CTA rank, each group's partial sums as
    its reduction team takes them (``_team_sums``), the cluster's combine (a
    butterfly over the ranks), the statistics, and the apply, in x's
    dtype [B, C, *spatial]."""
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    es = x.element_size()
    vec = 16 // es
    cpg = c // groups
    gpb, k, px = plan.groups_per_band, plan.cluster, plan.pixels
    bandc = gpb * cpg
    nwarps = plan.threads // 32
    wpt = nwarps // gpb if gpb <= nwarps else 1
    tsz = 32 * wpt
    xf = x.float().reshape(b, c, hw)
    wf, bf = weight.float(), bias.float()
    y = torch.empty((b, c, hw), dtype=torch.float32)
    inv_count = 1.0 / torch.tensor(float(cpg) * float(hw), dtype=torch.float32)
    for band in range(plan.bands):
        bi, c0 = band // (groups // gpb), (band % (groups // gpb)) * bandc
        xb = xf[bi, c0:c0 + bandc]                         # [bandc, hw]
        red = []
        for rank in range(k):
            share = xb[:, rank * px:(rank + 1) * px]
            sums = []
            for g in range(gpb):
                part = share[g * cpg:(g + 1) * cpg]
                if plan.layout == "rows":
                    phases = [_strided(part.reshape(-1, vec), tsz)]
                else:
                    # tile element i is global element gbase + i; vectors sit
                    # on 16-byte boundaries of the band's range
                    flat = xb.reshape(-1)
                    gbase = (bi * c + c0) * hw
                    shift = gbase % vec
                    head = min(flat.numel(), (vec - shift) % vec)
                    tail0 = head + (flat.numel() - head) // vec * vec
                    a, e = g * cpg * hw, (g + 1) * cpg * hw
                    va, ve = max(a, head) - head, min(e, tail0) - head
                    v0, v1 = -(-va // vec), (ve // vec if ve > 0 else 0)
                    lo, hi = (head + v0 * vec, head + v1 * vec) if v1 > v0 else (e, e)
                    phases = []
                    if v1 > v0:
                        phases.append(_strided(flat[head + v0 * vec:head + v1 * vec]
                                               .reshape(-1, vec), tsz))
                    for seg in (flat[a:lo], flat[hi:e]):
                        if seg.numel():
                            phases.append(_strided(seg.reshape(-1, 1), tsz))
                sums.append(_team_sums(phases, tsz))
            red.append(sums)
        for g in range(gpb):
            if k == 1:
                t, t2 = red[0][g]
            else:   # the cluster's combine: a butterfly over the ranks' partials
                t = _butterfly(torch.stack([red[r][g][0] for r in range(k)]))
                t2 = _butterfly(torch.stack([red[r][g][1] for r in range(k)]))
            mean = t * inv_count
            var = torch.clamp_min(t2 * inv_count - mean * mean, 0.0)
            rstd = torch.rsqrt(var + torch.tensor(eps, dtype=torch.float32))
            ch = slice(c0 + g * cpg, c0 + (g + 1) * cpg)
            xg = xf[bi, ch]
            v = (xg - mean) * (rstd * wf[ch])[:, None] + bf[ch][:, None]
            y[bi, ch] = v * torch.sigmoid(v) if with_silu else v
    return y.to(x.dtype).reshape(x.shape)


# ---- the wrappers -------------------------------------------------------------

class _GNArgs(ctypes.Structure):
    """csrc/gn_silu.cu::GNArgs: the shape and the plan of one launch."""
    _fields_ = [("hw", ctypes.c_longlong)] + [(f, ctypes.c_int) for f in (
        "batch", "c", "groups", "silu", "dtype", "wdt", "bdt", "resident", "k", "gpb", "P",
        "rows", "threads", "smem_bytes", "clusters")] + [("eps", ctypes.c_float)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _args(shape: tuple, dtype, wdt, bdt, groups: int, eps: float, with_silu: bool,
          plan: GNPlan) -> _GNArgs:
    codes = _DTYPE_CODE.get(wdt), _DTYPE_CODE.get(bdt)
    if None in codes:
        raise TypeError("gn kernel: weight and bias must be bf16, f16 or f32")
    return _GNArgs(math.prod(shape[2:]), shape[0], shape[1], groups, int(bool(with_silu)),
                   _DTYPE_CODE[dtype], *codes, int(plan.route == "resident"), plan.cluster,
                   plan.groups_per_band, plan.pixels, int(plan.layout == "rows"), plan.threads,
                   plan.smem_bytes, plan.clusters, float(eps))


@functools.lru_cache(maxsize=1024)
def _launch_args(shape: tuple, dtype, groups: int, aligned: bool, dev: int, eps: float,
                 with_silu: bool, wdt, bdt):
    """(plan, _GNArgs) of a call: built once a distinct call."""
    plan = gn_plan(shape, dtype, groups, aligned, _sm_count(dev))
    return plan, _args(shape, dtype, wdt, bdt, groups, eps, with_silu, plan)


def _launch(x, weight, bias, out, args: _GNArgs, plan: GNPlan, dev: int):
    fn = load("gn_silu").vd_gn_silu
    ptrs = (x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(), ctypes.byref(args))
    if dev == torch.cuda.current_device():
        rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu launch failed: cudaError {rc} ({plan})")


def _device(x) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def gn_cluster_capacity(k: int, threads: int, smem_bytes: int) -> int:
    """Clusters of k CTAs of ``threads`` threads and ``smem_bytes`` shared
    memory the current card holds at once (GN_CLUSTERS records an H100's at
    one CTA an SM)."""
    fn = load("gn_silu").vd_gn_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(k, threads, smem_bytes)


def gn_variant(shape: tuple, dtype: torch.dtype, groups: int, route: str, k: int):
    """gn_plan's plan on ``route`` with clusters of ``k`` (for measuring the
    plan's choices), or None where the kernel cannot take it."""
    base = gn_plan(shape, dtype, groups)
    es = torch.empty((), dtype=dtype).element_size()
    hw = math.prod(shape[2:])
    if base.layout == "rows":
        if hw % k or (hw // k) % (16 // es):
            return None
    elif k > 1 or route == "streaming":
        return None
    bandc = base.groups_per_band * (shape[1] // groups)
    threads = 512 if route == "streaming" else _gn_threads(bandc * hw // k, 16 // es)
    smem = gn_smem_bytes(route, base.layout, threads, base.groups_per_band, bandc, hw // k, hw,
                         es)
    if smem > GN_MAX_SMEM:
        return None
    clusters = base.bands if route == "resident" else min(base.bands, GN_CLUSTERS[k])
    return dataclasses.replace(base, route=route, cluster=k, pixels=hw // k, threads=threads,
                               smem_bytes=smem, clusters=clusters)


def gn_launch_plan(x, weight, bias, out, groups: int, eps: float, with_silu: bool,
                   plan: GNPlan):
    """One launch on a given plan (``gn_variant``), for
    measuring the routes against each other; counts no launch."""
    args = _args(tuple(x.shape), x.dtype, weight.dtype, bias.dtype, groups, eps, with_silu, plan)
    _launch(x, weight, bias, out, args, plan, _device(x))


def _gn_out(x):
    """y for x: x's shape and dtype at the same address modulo 16 (the
    flat layout's vectors line up in both)."""
    off = x.data_ptr() % 16
    if off == 0:
        return torch.empty_like(x)
    es = x.element_size()
    buf = torch.empty(x.numel() + 16 // es, dtype=x.dtype, device=x.device)
    skip = ((off - buf.data_ptr() % 16) % 16) // es
    return buf[skip:skip + x.numel()].view(x.shape)


def _gn_silu_fwd(x, weight, bias, groups: int, eps: float, with_silu: bool):
    """The GN(+SiLU) kernel, or its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, weight, bias, groups, eps, with_silu)
    _check_gn_input("gn_silu", x, groups, weight, bias)
    y = _gn_out(x)
    dev = _device(x)
    plan, args = _launch_args(tuple(x.shape), x.dtype, groups, x.data_ptr() % 16 == 0, dev,
                              float(eps), with_silu, weight.dtype, bias.dtype)
    _launch(x, weight, bias, y, args, plan, dev)
    gn_silu.launches += 1
    gn_silu.launches_by_path[plan.route] += 1
    return y


class GNSiLU(torch.autograd.Function):
    """``_gn_silu``'s custom_vjp: the forward is the kernel; the backward
    recomputes the plain version from the saved (x, weight, bias) and
    differentiates it, as the JAX package's vjp differentiates
    ``_ref_gn_silu`` (there is no backward kernel on either side)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, groups: int, eps: float, with_silu: bool):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (groups, eps, with_silu)
        return _gn_silu_fwd(x, weight, bias, groups, eps, with_silu)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            y = gn_silu_plain(*ins, *ctx.cfg)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(y, wrt, gy))
        return tuple(next(grads) if n else None for n in need) + (None, None, None)


def gn_silu(x, weight, bias, groups: int = 32, eps: float = 1e-5, with_silu: bool = True):
    """GroupNorm(groups)(+SiLU) over the channel axis of [B, C, *spatial],
    differentiable in x, weight and bias."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GNSiLU.apply(x, weight, bias, groups, eps, with_silu)
    return _gn_silu_fwd(x, weight, bias, groups, eps, with_silu)


gn_silu.launches = 0
gn_silu.launches_by_path = {"resident": 0, "streaming": 0}   # gn_plan's route -> launches


def _check_gn_input(name: str, x, groups: int, weight=None, bias=None):
    """Shape/type checks shared by the kernel wrappers (CUDA tensors)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() < 2 or x.shape[1] % groups or x.numel() == 0:
        raise ValueError(f"{name}: {groups} groups do not divide shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name} kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous channel-first tensor")
    c = x.shape[1]
    for t in (weight, bias):
        if t is not None and (t.shape != (c,) or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: weight and bias must be contiguous [C] on x's device")


# ---- gn_stats: the Triton split reduction ------------------------------------

_kernels = None


def _triton_kernels():
    global _kernels
    if _kernels is not None:
        return _kernels
    from vdtpu_torch.ops.kernels.build import use_triton_cache_dir
    use_triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats_kernel(x_ptr, part_ptr, L, CHUNK, S: tl.constexpr, BLOCK: tl.constexpr):
        bg = tl.program_id(0)
        s = tl.program_id(1)
        base = x_ptr + bg.to(tl.int64) * L
        start = s * CHUNK
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            xv = tl.load(base + idx, mask=idx < L, other=0.0).to(tl.float32)
            acc += xv
            acc2 += xv * xv
        out = part_ptr + (bg * S + s) * 2
        tl.store(out, tl.sum(acc, axis=0))
        tl.store(out + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def gn_finalize_kernel(part_ptr, out_ptr, C, CPG, G, inv_count, eps, S: tl.constexpr,
                           SP: tl.constexpr, BC: tl.constexpr):
        b = tl.program_id(0)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        cm = c < C
        so = tl.arange(0, SP)
        row = (b * G + c // CPG) * S
        m2 = cm[:, None] & (so[None, :] < S)
        tot = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2, mask=m2, other=0.0), 1)
        tot2 = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2 + 1, mask=m2,
                              other=0.0), 1)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        tl.store(out_ptr + b * 2 * C + c, mean, mask=cm)
        tl.store(out_ptr + b * 2 * C + C + c, rstd, mask=cm)

    @triton.jit
    def gn_apply_q_kernel(x_ptr, q_ptr, w_ptr, b_ptr, part_ptr, s_ptr, C, HW, CPG, G,
                          inv_count, eps, S: tl.constexpr, SP: tl.constexpr,
                          BC: tl.constexpr, BP: tl.constexpr, WITH_SILU: tl.constexpr):
        b = tl.program_id(0)
        p = tl.program_id(1) * BP + tl.arange(0, BP)
        c = tl.program_id(2) * BC + tl.arange(0, BC)
        cm = c < C
        so = tl.arange(0, SP)
        row = (b * G + c // CPG) * S
        m2 = cm[:, None] & (so[None, :] < S)
        tot = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2, mask=m2, other=0.0), 1)
        tot2 = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2 + 1, mask=m2,
                              other=0.0), 1)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + c, mask=cm, other=0.0).to(tl.float32)
        bb = tl.load(b_ptr + c, mask=cm, other=0.0).to(tl.float32)
        inv = 1.0 / tl.load(s_ptr)
        m = cm[:, None] & (p[None, :] < HW)
        base = b.to(tl.int64) * C * HW
        xv = tl.load(x_ptr + base + c[:, None] * HW + p[None, :], mask=m, other=0.0)
        y = (xv.to(tl.float32) - mean[:, None]) * rstd[:, None] * w[:, None] + bb[:, None]
        if WITH_SILU:
            y = y / (1.0 + tl.exp(-y))
        v = tl.minimum(tl.maximum(y * inv, -127.0), 127.0)
        # round half to even: adding and removing 1.5 * 2^23 leaves the
        # nearest integer, ties to even, for |v| <= 2^22
        v = (v + 12582912.0) - 12582912.0
        tl.store(q_ptr + base + p[None, :] * C + c[:, None], v.to(tl.int8), mask=m)


    _kernels = (triton, gn_stats_kernel, gn_finalize_kernel, gn_apply_q_kernel)
    return _kernels


def _stats_partials(x, groups: int):
    """Launch the stats pass; returns (partials [B*G, S, 2], S, group_len,
    the elements each of the S programs of a group reads)."""
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    group_len = (c // groups) * hw
    bg = b * groups
    s = split_count(bg, group_len)
    chunk = -(-group_len // (s * _BLOCK)) * _BLOCK
    stats_k = _triton_kernels()[1]
    part = torch.empty((bg, s, 2), dtype=torch.float32, device=x.device)
    stats_k[(bg, s)](x, part, group_len, chunk, S=s, BLOCK=_BLOCK, num_warps=4)
    return part, s, group_len, chunk


def gn_stats(x, groups: int = 32, eps: float = 1e-5):
    """[B, C, *spatial] -> [B, 2, C] f32 channel-broadcast (mean, rstd)."""
    if x.device.type == "cpu":
        return gn_stats_plain(x, groups, eps)
    _check_gn_input("gn_stats", x, groups)
    b, c = x.shape[:2]
    triton, _, fin_k, _ = _triton_kernels()
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        part, s, group_len, _ = _stats_partials(x, groups)
        fin_k[(b, triton.cdiv(c, _QBLOCK))](
            part, out, c, c // groups, groups, 1.0 / group_len, float(eps), S=s,
            SP=max(2, triton.next_power_of_2(s)), BC=_QBLOCK, num_warps=4)
    gn_stats.launches += 1
    return out


gn_stats.launches = 0


def gn_silu_q(x, weight, bias, s_act, groups: int = 32, eps: float = 1e-5,
              with_silu: bool = True):
    """GroupNorm(+SiLU)+int8 quantize: [B, C, *spatial] in, channels-last
    int8 codes [B, *spatial, C] out; ``s_act`` is the static activation
    scale (a 0-d f32 tensor on x's device)."""
    if x.device.type == "cpu":
        return gn_silu_q_plain(x, weight, bias, s_act, groups, eps, with_silu)
    _check_gn_input("gn_silu_q", x, groups, weight, bias)
    if not (torch.is_tensor(s_act) and s_act.numel() == 1 and s_act.dtype == torch.float32
            and s_act.device == x.device):
        raise ValueError("gn_silu_q: s_act must be a one-element f32 tensor on x's device")
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    triton, _, _, apply_q = _triton_kernels()
    q = torch.empty((b,) + tuple(x.shape[2:]) + (c,), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        part, s, group_len, _ = _stats_partials(x, groups)
        apply_q[(b, triton.cdiv(hw, _QBLOCK), triton.cdiv(c, _QBLOCK))](
            x, q, weight, bias, part, s_act, c, hw, c // groups, groups, 1.0 / group_len,
            float(eps), S=s, SP=max(2, triton.next_power_of_2(s)), BC=_QBLOCK, BP=_QBLOCK,
            WITH_SILU=bool(with_silu), num_warps=4)
    gn_silu_q.launches += 1
    return q


gn_silu_q.launches = 0

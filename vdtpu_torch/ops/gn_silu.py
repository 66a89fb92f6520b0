"""GroupNorm(+SiLU): a hand-written CUDA C++ kernel and its plain version;
the int8 policy's GroupNorm kernels (CUDA C++).

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

The int8 serving policy adds two hand-written CUDA kernels in
``csrc/gn_q.cu`` (its source note has the design), one launch a call each:
  - ``gn_silu_q``: GroupNorm(+SiLU) then int8 codes with the static
    activation scale, clip(round half to even(y * (1 / s)), -127, 127): the
    multiply by the reciprocal of ``_kernel_q`` / ``_apply_q_kernel``, not
    ``_quantize_act``'s divide (codes can differ by one at rounding
    boundaries; ROADMAP queue 3). Replaces ``gn_silu_q`` (``_kernel_q``)
    and ``_gn_silu_q_blocked`` (``_stats_kernel`` + ``_apply_q_kernel``).
    One cooperative launch: a CTA's tile is (sample, a slice of Cs = 32
    channels (16, 8 where C does not divide), a range of P pixels); phase 1
    sums each channel's x and x^2 over the tile into a workspace of
    per-channel partials [B, C, ranges]; after one grid barrier, phase 2
    combines the partials of the groups a slice touches (a slice may cut a
    group) in one fixed order, copies the tile in again from L2, normalizes,
    applies the affine and SiLU, quantizes into a code buffer in shared
    memory, transposed, and stores each pixel's run as 16-byte vectors into
    the channels-last [B, *spatial, C] layout the int8 conv
    (``ops/qconv.py``) reads as its implicit-GEMM K axis.
  - ``gn_stats``: [B, 2, C] f32 channel-broadcast (mean, rstd). Replaces
    ``vdtpu/ops/pallas/gn_silu.py::gn_stats`` (its ``_stats_kernel``). One
    CTA a (sample, group) sums the group's contiguous range ("group" route)
    where a group is whole 16-byte vectors of an aligned x; the cooperative
    kernel without its apply takes the other shapes.
``gnq_plan`` picks the route ("streaming": 16-byte vectors; "general":
scalar loads for rows that are not 16-byte runs or codes that are not
whole vectors; "group" for ``gn_stats``), Cs, P, the threads and the shared
memory, and raises on what the kernels do not take; the C entry points
recompute it and refuse a plan that is not theirs. Bound: one read of x and
one s8 write (``gn_stats``: one read of x), at [4, 320, 64, 64] bf16 0.0047
(0.0031) ms at 3.35 TB/s. ``gnq_blocked_plain`` is the kernels' order of
work on the CPU.

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




# ---- the int8 GroupNorm kernels (csrc/gn_q.cu): the plan ---------------------

GNQ_THREADS = (128, 256)
GNQ_REGS = 48                # registers a thread: csrc/gn_q.cu's __launch_bounds__(256, 5)
GNQ_VECTORS = (1, 2, 4, 8)   # 16-byte vectors a lane sums in a tile (the streaming route)
GNQ_SCALARS = (2, 4, 8, 16, 32)  # elements a lane sums in a tile (the general route)
# a CTA's fixed cost in the plan's cost (its group combine, table, barrier
# and tail), in bytes of x an SM would move meanwhile
GNQ_CTA_BYTES = 4096
GNQ_GROUP_THREADS = 512      # gn_stats' group route: a CTA a (sample, group)
_GNQ_ROUTE_CODE = {"streaming": 0, "general": 1}


@dataclasses.dataclass(frozen=True)
class GNQPlan:
    """Geometry of one ``csrc/gn_q.cu`` launch. A tile is (sample, a slice
    of ``cs`` channels, a range of ``pixels`` pixels); there are ``ranges``
    ranges a channel and ``tiles`` tiles, walked by ``ctas`` CTAs of
    ``threads`` threads (``threads / cs`` lanes a channel row) and
    ``smem_bytes`` shared memory, in one cooperative launch with one grid
    barrier. ``route``: "streaming" (gn_silu_q on 16-byte vectors; phase 2
    copies each tile in again), "general" (scalar loads, masked code
    stores; any shape; gn_stats' cooperative kernel), or "group" (gn_stats,
    ``vd_gn_stats_group``: a CTA a (sample, group) summing the group's
    ``pixels`` contiguous elements; ``tiles`` = ``ctas`` = B * G, ``cs``
    0)."""
    route: str
    cs: int
    pixels: int
    threads: int
    ranges: int
    tiles: int
    ctas: int
    smem_bytes: int

    @property
    def tiles_per_cta(self) -> int:
        return -(-self.tiles // self.ctas)


def gnq_smem_bytes(stats: bool, cs: int, pixels: int, es: int) -> int:
    """Shared memory of a launch, as csrc/gn_q.cu::smem_bytes lays it out:
    the tile and its codes (gn_silu_q), then the per-channel table and the
    groups' statistics (24 bytes a channel of the slice)."""
    r16 = lambda n: -(-n // 16) * 16
    return (0 if stats else r16(cs * pixels * es) + r16(cs * pixels)) + 24 * cs


def gnq_blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """CTAs of the kernel an SM holds at once: by threads (2048), registers
    (GNQ_REGS a thread), shared memory (GN_SM_SMEM, 1 KB reserved a CTA) and
    blocks (32). ``vd_gnq_blocks_per_sm`` asks the card (``gnq_sweep``)."""
    return min(32, 2048 // threads, 65536 // (threads * GNQ_REGS),
               GN_SM_SMEM // (smem_bytes + 1024))


def _gnq_shape(shape: tuple, dtype: torch.dtype, groups: int):
    """(b, c, hw, itemsize), or raises on what the kernel does not take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"gn int8 kernels: unsupported dtype {dtype}")
    b, c = shape[0], shape[1]
    hw = math.prod(shape[2:])
    if b < 1 or c < 1 or hw < 1 or groups < 1 or c % groups:
        raise ValueError(f"gnq_plan: {groups} groups do not divide shape {tuple(shape)}")
    return b, c, hw, torch.empty((), dtype=dtype).element_size()


def gnq_vector_route(shape: tuple, dtype: torch.dtype, aligned: bool = True) -> bool:
    """gn_silu_q's streaming route: rows of whole 16-byte vectors from an
    aligned x and C % 8 == 0, so that a pixel's codes of a slice are one 8-
    or 16-byte store; else the general route."""
    es = torch.empty((), dtype=dtype).element_size()
    return aligned and (math.prod(shape[2:]) * es) % 16 == 0 and shape[1] % 8 == 0


def gnq_slice(c: int, stats: bool) -> int:
    """Channels a slice: 32 where C % 32 == 0 (gn_silu_q: each pixel's codes
    one whole 32-byte sector), else 16 where C % 16 == 0, else 8 (the
    cooperative kernel's statistics: 16 or 8)."""
    return 32 if c % 32 == 0 and not stats else 16 if c % 16 == 0 else 8


def gnq_group_plan(shape: tuple, dtype: torch.dtype, groups: int,
                   aligned: bool = True) -> GNQPlan | None:
    """gn_stats' group route (a CTA a (sample, group)) where a group is whole
    16-byte vectors of an aligned x, else None."""
    b, c, hw, es = _gnq_shape(shape, dtype, groups)
    count = c // groups * hw
    if not aligned or count % (16 // es):
        return None
    return GNQPlan("group", 0, count, GNQ_GROUP_THREADS, 1, b * groups, b * groups, 0)


def gnq_variants(shape: tuple, dtype: torch.dtype, groups: int, sms: int = NUM_SMS,
                 stats: bool = False, aligned: bool = True, cs: int | None = None) -> list:
    """Every plan the kernels take for x of ``shape`` (``cs``: the slice's
    channels, default gnq_plan's): each thread count of GNQ_THREADS and each
    tile length (GNQ_VECTORS 16-byte vectors a lane on the streaming route,
    GNQ_SCALARS elements on the general route) up to the one that covers a
    row, with the fewest CTAs that the card holds at once and that share the
    tiles evenly; gn_stats' cooperative plans are general ones, and its
    group plan follows them where it applies."""
    b, c, hw, es = _gnq_shape(shape, dtype, groups)
    cs = cs or gnq_slice(c, stats)
    vec = not stats and gnq_vector_route(shape, dtype, aligned)
    route, lengths = ("streaming", GNQ_VECTORS) if vec else ("general", GNQ_SCALARS)
    out = []
    for threads in GNQ_THREADS:
        tpr = threads // cs
        if tpr < 4:
            continue
        unit = tpr * (16 // es if vec else 1)
        for n in lengths:
            pixels = unit * n
            if n > lengths[0] and pixels // 2 >= hw:
                break   # the last length covered the row
            smem = gnq_smem_bytes(stats, cs, pixels, es)
            if smem > GN_MAX_SMEM:
                break
            ranges = -(-hw // pixels)
            tiles = b * -(-c // cs) * ranges
            cap = sms * gnq_blocks_per_sm(threads, smem)
            ctas = -(-tiles // -(-tiles // cap))
            out.append(GNQPlan(route, cs, pixels, threads, ranges, tiles, ctas, smem))
    group = gnq_group_plan(shape, dtype, groups, aligned) if stats else None
    return out + ([group] if group else [])


def gnq_cost(plan: GNQPlan, es: int, sms: int = NUM_SMS) -> float:
    """A cooperative plan's cost: the busiest SM's CTAs (ctas / sms, rounded
    up) times a CTA's tiles times a tile's bytes of x at 1.5 (phase 2's
    second read, from L2, at half) and GNQ_CTA_BYTES."""
    tile = plan.cs * plan.pixels * es * 1.5
    return -(-plan.ctas // sms) * plan.tiles_per_cta * (tile + GNQ_CTA_BYTES)


@functools.lru_cache(maxsize=512)
def gnq_plan(shape: tuple, dtype: torch.dtype, groups: int, sms: int = NUM_SMS,
             stats: bool = False, aligned: bool = True) -> GNQPlan:
    """The int8 GN kernels' plan for a contiguous x of ``shape`` [B, C,
    *spatial] (``stats``: gn_stats, else gn_silu_q; ``aligned``: x starts on
    a 16-byte boundary). Cs by ``gnq_slice``. gn_silu_q takes the streaming
    route, whose CTAs (one a tile wherever the tiles fit the card at once)
    sum phase 1 from global memory and copy the tile in again from L2 for
    phase 2; shapes whose rows are not 16-byte runs (or whose codes are not
    whole 8-byte runs) take the general route. gn_stats takes the group
    route where it applies (gnq_sweep read it faster than the cooperative
    kernel's statistics and than clusters of 2-8 CTAs a group, PERF.md),
    else the cooperative kernel's general route. Among the cooperative
    plans, the least ``gnq_cost``; on a tie the most tiles, then the most
    threads."""
    b, _, _, es = _gnq_shape(shape, dtype, groups)
    pool = gnq_variants(shape, dtype, groups, sms, stats, aligned)
    if pool[-1].route == "group":
        return pool[-1]
    return min(pool, key=lambda p: (gnq_cost(p, es, sms), -p.tiles, -p.threads))


# ---- the int8 kernels' order of work, on the CPU ------------------------------

def _gnq_partials(xf, plan: GNQPlan, es: int):
    """Phase 1: [B, C, ranges, 2] per-channel (sum, sum of squares), each
    channel row of a tile summed by its threads / cs lanes as
    ``_team_sums`` takes them (lane j: 16-byte vectors j, j + lanes, ...,
    or single elements on the general route)."""
    b, c, hw = xf.shape
    width = 16 // es if plan.route == "streaming" else 1
    tpr = plan.threads // plan.cs
    ws = torch.zeros((b, c, plan.ranges, 2), dtype=torch.float32)
    for bi in range(b):
        for ch in range(c):
            for pr in range(plan.ranges):
                seg = xf[bi, ch, pr * plan.pixels:(pr + 1) * plan.pixels]
                ws[bi, ch, pr] = torch.stack(_team_sums([_strided(seg.reshape(-1, width), tpr)],
                                                        tpr))
    return ws


def _gnq_finish(t, t2, count, eps: float):
    """(mean, rstd) as csrc/gn_q.cu::finish."""
    mean = t / count
    var = torch.clamp_min(t2 / count - mean * mean, 0.0)
    return torch.stack([mean, 1.0 / torch.sqrt(var + torch.tensor(eps, dtype=torch.float32))])


def _gnq_group_stats(ws, groups: int, count: float, eps: float):
    """Phase 2's combine: per (sample, group) a warp sums the group's cpg x
    ranges partials (lane l: items l, l + 32, ... in order, then a
    butterfly), then (mean, rstd). -> [B, G, 2]."""
    b, c = ws.shape[:2]
    cpg = c // groups
    cnt = torch.tensor(count, dtype=torch.float32)
    out = torch.empty((b, groups, 2), dtype=torch.float32)
    for bi in range(b):
        for g in range(groups):
            lanes = _strided(ws[bi, g * cpg:(g + 1) * cpg].reshape(-1, 2), 32)
            acc = torch.zeros((32, 2), dtype=torch.float32)
            for it in range(lanes.shape[0]):
                acc = acc + lanes[it]
            out[bi, g] = _gnq_finish(_butterfly(acc[:, 0]), _butterfly(acc[:, 1]), cnt, eps)
    return out


def _gnq_group_route_stats(xf, groups: int, eps: float, plan: GNQPlan, es: int):
    """The group route: per (sample, group) one CTA sums the group's range
    as a team of ``plan.threads`` threads (``_team_sums``: 16-byte vectors
    t, t + threads, ...), then (mean, rstd). -> [B, G, 2]."""
    b, c, hw = xf.shape
    count = torch.tensor(float(c // groups) * float(hw), dtype=torch.float32)
    out = torch.empty((b, groups, 2), dtype=torch.float32)
    for bi in range(b):
        for g, grp in enumerate(xf[bi].reshape(groups, -1)):
            t, t2 = _team_sums([_strided(grp.reshape(-1, 16 // es), plan.threads)], plan.threads)
            out[bi, g] = _gnq_finish(t, t2, count, eps)
    return out


def gnq_blocked_plain(x, weight, bias, s_act, groups: int, eps: float, with_silu: bool,
                      plan: GNQPlan, stats: bool = False):
    """``csrc/gn_q.cu``'s order of work for ``plan`` on CPU tensors: the
    per-channel partials of every tile (phase 1), the fixed-order combine
    of each group's partials (the group route: ``_gnq_group_route_stats``),
    then either the statistics [B, 2, C] (``stats``) or, tile by tile, the
    apply (x - mean by a fused multiply-add with rstd w and the bias, SiLU
    as y / (1 + exp(-y)), the reciprocal scale, half to even, +-127) and the
    transposed store of each pixel's codes into [B, *spatial, C] int8."""
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    es = x.element_size()
    cpg = c // groups
    xf = x.float().reshape(b, c, hw)
    if plan.route == "group":
        gs = _gnq_group_route_stats(xf, groups, eps, plan, es)
    else:
        gs = _gnq_group_stats(_gnq_partials(xf, plan, es), groups, float(cpg) * float(hw), eps)
    per_c = gs.repeat_interleave(cpg, dim=1)                   # [B, C, 2]
    if stats:
        return per_c.permute(0, 2, 1).contiguous()
    sc = per_c[..., 1] * weight.float()                        # [B, C] rstd w
    mu, bi_ = per_c[..., 0], bias.float().expand(b, c)
    inv = 1.0 / torch.as_tensor(s_act, dtype=torch.float32)
    q = torch.empty((b, hw, c), dtype=torch.int8)
    slices = -(-c // plan.cs)
    for t in range(plan.tiles):
        bs, pr = divmod(t, plan.ranges)
        bi, s = divmod(bs, slices)
        ch = slice(s * plan.cs, min(c, (s + 1) * plan.cs))
        px = slice(pr * plan.pixels, min(hw, (pr + 1) * plan.pixels))
        v = xf[bi, ch, px] - mu[bi, ch, None]
        y = (v.double() * sc[bi, ch, None].double() + bi_[bi, ch, None].double()).float()
        if with_silu:
            y = y / (1.0 + torch.exp(-y))
        q[bi, px, ch] = torch.round(y * inv).clamp(-127, 127).to(torch.int8).t()
    return q.reshape((b,) + tuple(x.shape[2:]) + (c,))


# ---- the int8 kernels' wrappers ------------------------------------------------

class _GNQArgs(ctypes.Structure):
    """csrc/gn_q.cu::GNQArgs: the shape and the plan of one launch."""
    _fields_ = [("hw", ctypes.c_longlong)] + [(f, ctypes.c_int) for f in (
        "batch", "c", "groups", "silu", "dtype", "wdt", "bdt", "route", "cs", "P", "threads",
        "ranges", "tiles", "ctas", "smem_bytes")] + [("eps", ctypes.c_float)]


class _GNSArgs(ctypes.Structure):
    """csrc/gn_q.cu::GNSArgs: vd_gn_stats_group's launch."""
    _fields_ = [("hw", ctypes.c_longlong)] + [(f, ctypes.c_int) for f in (
        "batch", "c", "groups", "dtype", "threads")] + [("eps", ctypes.c_float)]


@functools.cache
def _gnq_lib() -> ctypes.CDLL:
    """The library with every entry point's types (``build.SOURCES`` types
    vd_gn_silu_q)."""
    lib = load("gn_q")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, types in (("vd_gn_stats", [ptr] * 5), ("vd_gnq_blocks_per_sm", [i32] * 6),
                        ("vd_gn_stats_group", [ptr] * 4)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, i32
    lib.vd_gnq_set_trace.argtypes, lib.vd_gnq_set_trace.restype = [ptr], None
    return lib


def _gnq_args(shape: tuple, dtype, groups: int, eps: float, with_silu: bool, plan: GNQPlan,
              wdt=torch.float32, bdt=torch.float32):
    """The launch's arguments: _GNSArgs for the group route, else _GNQArgs."""
    if plan.route == "group":
        return _GNSArgs(math.prod(shape[2:]), shape[0], shape[1], groups, _DTYPE_CODE[dtype],
                        plan.threads, float(eps))
    codes = _DTYPE_CODE.get(wdt), _DTYPE_CODE.get(bdt)
    if None in codes:
        raise TypeError("gn_silu_q kernel: weight and bias must be bf16, f16 or f32")
    return _GNQArgs(math.prod(shape[2:]), shape[0], shape[1], groups, int(bool(with_silu)),
                    _DTYPE_CODE[dtype], *codes, _GNQ_ROUTE_CODE[plan.route], plan.cs,
                    plan.pixels, plan.threads, plan.ranges, plan.tiles, plan.ctas,
                    plan.smem_bytes, float(eps))


@functools.lru_cache(maxsize=1024)
def _gnq_launch_args(shape: tuple, dtype, groups: int, aligned: bool, dev: int, eps: float,
                     with_silu: bool, wdt, bdt, stats: bool):
    """(plan, _GNQArgs) of a call: built once a distinct call."""
    plan = gnq_plan(shape, dtype, groups, _sm_count(dev), stats, aligned)
    return plan, _gnq_args(shape, dtype, groups, eps, with_silu, plan, wdt, bdt)


_workspaces: dict = {}   # (device, float2 count) -> the per-channel partials' buffer


def _workspace(x, n: int):
    """Room for n float2 partials on x's device, allocated once a size and
    kept (launches on one stream take turns with it); while a CUDA graph is
    captured, a buffer of the graph's own."""
    key = (x.device, n)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.empty(2 * n, dtype=torch.float32, device=x.device)
        if not torch.cuda.is_current_stream_capturing():
            _workspaces[key] = ws
    return ws


def _gnq_call(name: str, ptrs: tuple, plan, dev: int):
    fn = getattr(_gnq_lib(), name)
    if dev == torch.cuda.current_device():
        rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({plan})")


def _check_scale(x, s_act):
    if not (torch.is_tensor(s_act) and s_act.numel() == 1 and s_act.dtype == torch.float32
            and s_act.device == x.device):
        raise ValueError("gn_silu_q: s_act must be a one-element f32 tensor on x's device")


def _gnq_launch(x, groups: int, eps: float, plan: GNQPlan, args, out, weight=None,
                bias=None, s_act=None):
    """One launch of either entry point (codes if ``s_act`` is given, else
    statistics) into ``out``."""
    dev = _device(x)
    if plan.route == "group":
        _gnq_call("vd_gn_stats_group", (x.data_ptr(), out.data_ptr(), ctypes.byref(args)),
                  plan, dev)
        return
    ws = _workspace(x, x.shape[0] * x.shape[1] * plan.ranges)
    if s_act is None:
        _gnq_call("vd_gn_stats", (x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                  ctypes.byref(args)), plan, dev)
    else:
        _gnq_call("vd_gn_silu_q", (x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                                   bias.data_ptr(), s_act.data_ptr(), ws.data_ptr(),
                                   ctypes.byref(args)), plan, dev)


def gn_stats(x, groups: int = 32, eps: float = 1e-5):
    """[B, C, *spatial] -> [B, 2, C] f32 channel-broadcast (mean, rstd)."""
    if x.device.type == "cpu":
        return gn_stats_plain(x, groups, eps)
    _check_gn_input("gn_stats", x, groups)
    b, c = x.shape[:2]
    plan, args = _gnq_launch_args(tuple(x.shape), x.dtype, groups, x.data_ptr() % 16 == 0,
                                  _device(x), float(eps), False, torch.float32,
                                  torch.float32, True)
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    _gnq_launch(x, groups, eps, plan, args, out)
    gn_stats.launches += 1
    gn_stats.launches_by_route[plan.route] += 1
    return out


gn_stats.launches = 0
gn_stats.launches_by_route = {"group": 0, "general": 0}   # gnq_plan's route -> launches


def gn_silu_q(x, weight, bias, s_act, groups: int = 32, eps: float = 1e-5,
              with_silu: bool = True):
    """GroupNorm(+SiLU)+int8 quantize: [B, C, *spatial] in, channels-last
    int8 codes [B, *spatial, C] out; ``s_act`` is the static activation
    scale (a 0-d f32 tensor on x's device)."""
    if x.device.type == "cpu":
        return gn_silu_q_plain(x, weight, bias, s_act, groups, eps, with_silu)
    _check_gn_input("gn_silu_q", x, groups, weight, bias)
    _check_scale(x, s_act)
    b, c = x.shape[:2]
    plan, args = _gnq_launch_args(tuple(x.shape), x.dtype, groups, x.data_ptr() % 16 == 0,
                                  _device(x), float(eps), bool(with_silu), weight.dtype,
                                  bias.dtype, False)
    q = torch.empty((b,) + tuple(x.shape[2:]) + (c,), dtype=torch.int8, device=x.device)
    _gnq_launch(x, groups, eps, plan, args, q, weight, bias, s_act)
    gn_silu_q.launches += 1
    gn_silu_q.launches_by_route[plan.route] += 1
    return q


gn_silu_q.launches = 0
gn_silu_q.launches_by_route = {"streaming": 0, "general": 0}


def gnq_launch_plan(x, out, plan: GNQPlan, groups: int, eps: float, weight=None, bias=None,
                    s_act=None, with_silu: bool = True):
    """One launch on a given plan (``gnq_variants``), for measuring the
    plan's choices against each other: codes into ``out`` if ``s_act`` is
    given, else statistics; counts no launch."""
    _check_gn_input("gnq_launch_plan", x, groups, weight, bias)
    if s_act is not None:
        _check_scale(x, s_act)
    wdt = weight.dtype if weight is not None else torch.float32
    bdt = bias.dtype if bias is not None else torch.float32
    args = _gnq_args(tuple(x.shape), x.dtype, groups, eps, with_silu, plan, wdt, bdt)
    _gnq_launch(x, groups, eps, plan, args, out, weight, bias, s_act)


def gnq_card_blocks_per_sm(plan: GNQPlan, dtype: torch.dtype, stats: bool) -> int:
    """Blocks of the plan's cooperative kernel an SM of the current card
    holds (against ``gnq_blocks_per_sm``, the plan's assumption)."""
    return _gnq_lib().vd_gnq_blocks_per_sm(int(not stats), _DTYPE_CODE[dtype], plan.cs,
                                           _GNQ_ROUTE_CODE[plan.route], plan.threads,
                                           plan.smem_bytes)

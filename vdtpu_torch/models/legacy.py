"""Legacy (pre-v2) diffuser zoo (``vdtpu/models/legacy.py``), NCHW: the
reference's older UNet families, kept for checkpoint compatibility.

- ``openai_unet``                      UNetModel (SD v1 / guided-diffusion UNet)
- ``openai_unet_dual_context``         UNetModelDualContext (VD-DC)
- ``openai_unet_nocontext``            UNetModelNoContext
- ``openai_unet_nocontext_noatt``      UNetModelNoContextNoAtt
- ``openai_unet_nocontext_noatt_decoderonly``  the decoder-only variant
- ``openai_unet_2d``                   UNetModel2D (the pre-next image trunk)
- ``openai_unet_0d``                   UNetModel0D (the pre-next text trunk)
- ``openai_unet_0dmd``                 UNetModel0D_MultiDim
- ``openai_unet_vd``                   UNetModelVD (two-trunk zip walk, VD v1)

Each family replays the reference's construction loop once into a static
program of stages (``build_conv_program`` / ``build_fc_program``, the JAX
package's plain-Python builders, copied) and builds its modules into
``nn.ModuleList``s at the stages' positions, so parameter names are the
reference's torch keys (``input_blocks.3.0.in_layers.2.weight``). The
parameter-free resamples (average pool, nearest 2x) hold their slot as
modules without parameters. Every GroupNorm runs through the GN(+SiLU)
kernel (the scale-shift FiLM norms without SiLU) and every attention
through ``ops/attention.py``, so the long self-attentions take the flash
kernel, the AttentionBlock's on strided views of its fused qkv.

The 0-D stream is NCHW [B, C, 1, 1] (``openai_unet_0d``, whose input
convs and downsamples are real 1x1 / 3x3-stride-2 convs) or the flat
channel-major [B, C*S] (``openai_unet_0dmd``, everything linear).

Weights: the layers that the reference stores as 1x1 Conv2d or width-1
Conv1d and the JAX package as dense kernels (the AttentionBlock's ``qkv``
and ``proj_out``, the transformers' ``proj_in`` / ``proj_out``, the FC
blocks' convs) load by the tensor's rank: a [O, I], [O, I, 1] or
[O, I, 1, 1] weight loads into the port's layer of either rank, and a
Conv1d of width other than 1 raises (``weight_by_rank``).

``use_checkpoint`` rematerializes the ResBlocks, FC blocks and
transformers under autograd; ``use_fp16`` and ``image_size`` are accepted
and ignored, as in the JAX package; ``dims`` other than 2 raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vdtpu_torch.models.blocks import FCBlock
from vdtpu_torch.models.layers import (
    Conv1x1Linear, Downsample2D, GroupNorm32, TimeEmbedMLP, Upsample2D, conv3, dense, zero_init)
from vdtpu_torch.models.transformer import BasicTransformerBlock, SpatialTransformer
from vdtpu_torch.ops.attention import scaled_dot_product_attention
from vdtpu_torch.ops.schedules import timestep_embedding


def _nn_up2(x):
    """Parameter-free nearest 2x (ref Upsample(use_conv=False))."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _avg_pool2(x):
    """2x2 stride-2 average pool (ref Downsample(use_conv=False))."""
    return F.avg_pool2d(x, 2)


class _Resample(nn.Module):
    """A parameter-free resample holding its slot in the module list."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class LegacyResBlock(nn.Module):
    """Reference ResBlock (openaimodel.py:162-274) with the options the v2
    blocks dropped: FiLM as scale-shift norm (GroupNorm without SiLU, then
    ``h * (1 + scale) + shift``, then SiLU), in-block up/downsampling
    (parameter-free), a 3x3 or 1x1 skip conv, dropout while training."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int, dropout: float = 0.0,
                 scale_shift: bool = False, up: bool = False, down: bool = False,
                 conv_skip: bool = False):
        super().__init__()
        self.scale_shift, self.up, self.down = scale_shift, up, down
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.Identity(),
                                        conv3(channels, out_channels, quant=False)])
        e_dim = 2 * out_channels if scale_shift else out_channels
        self.emb_layers = nn.ModuleList([nn.Identity(), dense(emb_dim, e_dim, quant=False)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.Identity(),
                                         nn.Dropout(dropout),
                                         conv3(out_channels, out_channels, zero=True,
                                               quant=False)])
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        elif conv_skip:
            self.skip_connection = conv3(channels, out_channels, quant=False)
        else:
            self.skip_connection = nn.Conv2d(channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers[0](x, silu=True)
        if self.up:
            h, x = _nn_up2(h), _nn_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.in_layers[2](h)
        e = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1.0 + scale) + shift)
        else:
            h = self.out_layers[0](h + e, silu=True)
        h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h


class LegacyAttentionBlock(nn.Module):
    """Self-attention block (openaimodel.py:277-323) on the channel-first
    [B, C, N] view: GN -> fused qkv -> attention -> zero proj_out, residual.
    ``new_order`` picks the qkv channel layout: legacy splits heads before
    q/k/v ([H, 3, d]), new splits q/k/v before heads ([3, H, d]). q, k and
    v are strided views of the one qkv tensor, handed to the attention as
    they are. Softmax scale d**-0.5 (ch**-0.25 on both operands)."""

    def __init__(self, channels: int, heads: int, new_order: bool = False):
        super().__init__()
        self.heads, self.new_order = heads, new_order
        self.norm = GroupNorm32(channels)
        self.qkv = dense(channels, 3 * channels, quant=False)
        self.proj_out = dense(channels, channels, zero=True, quant=False)

    def forward(self, x):
        b, c, n = x.shape
        d = c // self.heads
        qkv = self.qkv(self.norm(x).transpose(1, 2))
        if self.new_order:
            qkv = qkv.view(b, n, 3, self.heads, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            qkv = qkv.view(b, n, self.heads, 3, d)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        out = scaled_dot_product_attention(q, k, v).reshape(b, n, c)
        return x + self.proj_out(out).transpose(1, 2)


class DualSpatialTransformer(nn.Module):
    """Two transformer branches over one trunk feature (ref attention.py:
    345-435, VD-DC's context layer), keys ``norm_i``, ``proj_in_i``,
    ``transformer_blocks_i.d``, ``proj_out_i``. ``which`` 0 or 1 runs that
    branch (``x + branch``); a float r blends ``b0 * r + b1 * (1 - r) + x``
    with branch i on ``context[i]`` (the two may differ in length)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int | None,
                 depth: int = 1, disable_self_attn: bool = False):
        super().__init__()
        inner = heads * dim_head
        for i in (0, 1):
            self.add_module(f"norm_{i}", GroupNorm32(channels, eps=1e-6))
            self.add_module(f"proj_in_{i}", Conv1x1Linear(channels, inner))
            self.add_module(f"transformer_blocks_{i}", nn.ModuleList(
                [BasicTransformerBlock(inner, heads, dim_head, context_dim, disable_self_attn)
                 for _ in range(depth)]))
            self.add_module(f"proj_out_{i}", Conv1x1Linear(inner, channels, zero_init=True))

    def _branch(self, i: int, x, context):
        m = self._modules
        h = m[f"proj_in_{i}"](m[f"norm_{i}"](x).transpose(1, 2))
        for block in m[f"transformer_blocks_{i}"]:
            h = block(h, context)
        return m[f"proj_out_{i}"](h)

    def forward(self, x, context=None, which=None):
        """x: [B, C, N] channel-first; returns the same layout."""
        tokens = x.transpose(1, 2)
        if isinstance(which, int) and which in (0, 1):
            return (tokens + self._branch(which, x, context)).transpose(1, 2)
        c0, c1 = context
        out = self._branch(0, x, c0) * which + self._branch(1, x, c1) * (1.0 - which) + tokens
        return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# layer programs (plain Python; the JAX package's builders)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLayer:
    kind: str            # conv_in|res|res_up|res_down|attn|st|dual|up|down|
                         # pool|nn_up | lin_in|conv1_in|fc|lin|conv1|down0d
    name: str            # torch state-dict prefix, e.g. "input_blocks.3.1"
    ch: int = 0
    out_ch: int = 0
    heads: int = 0
    dim_head: int = 0
    depth: int = 1
    new_order: bool = False
    scale_shift: bool = False
    disable_self: bool = False


Stage = tuple  # tuple[LLayer, ...]


def _normalize_res_blocks(num_res_blocks, channel_mult) -> tuple[int, ...]:
    if isinstance(num_res_blocks, int):
        return (num_res_blocks,) * len(channel_mult)
    if len(num_res_blocks) != len(channel_mult):
        raise ValueError("num_res_blocks must be an int or match channel_mult")
    return tuple(num_res_blocks)


def build_conv_program(
    in_channels: int, model_channels: int, out_channels: int,
    num_res_blocks, channel_mult: Sequence[int],
    *,
    attn: str,                       # 'st' | 'dual' | 'self' | 'none'
    attention_resolutions: Sequence[int] = (),
    with_attn: Sequence[bool] | None = None,   # 2D-family per-level switch
    num_heads: int = -1, num_head_channels: int = -1,
    num_heads_upsample: int = -1,
    use_scale_shift_norm: bool = False, resblock_updown: bool = False,
    conv_resample: bool = True, transformer_depth: int = 1,
    use_new_attention_order: bool = False, legacy: bool = True,
    disable_self_attentions=None, num_attention_blocks=None,
    middle_attn: bool = True,
) -> tuple[tuple[Stage, ...], Stage, tuple[Stage, ...]]:
    """Replays the reference construction loops into a static program.

    Mirrors UNetModel (openaimodel.py:536-726) when ``with_attn is None``
    and the 2D family (UNetModel2D :1986-2067) when ``with_attn`` is given
    (plain dim_head = ch // num_heads, per-level attention). The local
    ``num_heads`` mutation at :565/:619/:673 is reproduced via ``nh``.
    """
    nrb = _normalize_res_blocks(num_res_blocks, channel_mult)
    if num_heads_upsample == -1:
        num_heads_upsample = num_heads
    use_st = attn in ("st", "dual")
    nh = num_heads

    def attn_spec(name: str, ch: int, level: int, heads_param: int) -> LLayer:
        nonlocal nh
        if with_attn is not None:
            dim_head = ch // nh
        elif num_head_channels == -1:
            dim_head = ch // nh
        else:
            nh = ch // num_head_channels
            dim_head = num_head_channels
        if with_attn is None and legacy:
            dim_head = ch // nh if use_st else num_head_channels
        disabled = bool(disable_self_attentions[level]) \
            if disable_self_attentions is not None else False
        if attn == "dual":
            return LLayer("dual", name, ch=ch, heads=nh, dim_head=dim_head,
                          depth=transformer_depth, disable_self=disabled)
        if attn == "st":
            return LLayer("st", name, ch=ch, heads=nh, dim_head=dim_head,
                          depth=transformer_depth, disable_self=disabled)
        # AttentionBlock's own head resolution (openaimodel.py:294-300),
        # receiving num_head_channels=dim_head:
        bh = heads_param if dim_head == -1 else ch // dim_head
        return LLayer("attn", name, ch=ch, heads=bh,
                      new_order=use_new_attention_order)

    def has_attn(level: int, block_idx: int, ds: int) -> bool:
        if attn == "none":
            return False
        if with_attn is not None:
            return bool(with_attn[level])
        if ds not in attention_resolutions:
            return False
        return num_attention_blocks is None or \
            block_idx < num_attention_blocks[level]

    res = lambda name, ci, co: LLayer("res", name, ch=ci, out_ch=co,
                                      scale_shift=use_scale_shift_norm)
    mc = model_channels
    stages_in: list[Stage] = [(LLayer("conv_in", "input_blocks.0.0",
                                      ch=in_channels, out_ch=mc),)]
    chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(channel_mult):
        for nr in range(nrb[level]):
            i = len(stages_in)
            st = [res(f"input_blocks.{i}.0", ch, mult * mc)]
            ch = mult * mc
            if has_attn(level, nr, ds):
                st.append(attn_spec(f"input_blocks.{i}.1", ch, level, nh))
            stages_in.append(tuple(st))
            chans.append(ch)
        if level != len(channel_mult) - 1:
            i = len(stages_in)
            if resblock_updown:
                down = LLayer("res_down", f"input_blocks.{i}.0", ch=ch,
                              out_ch=ch, scale_shift=use_scale_shift_norm)
            elif conv_resample:
                down = LLayer("down", f"input_blocks.{i}.0", ch=ch, out_ch=ch)
            else:
                down = LLayer("pool", f"input_blocks.{i}.0", ch=ch, out_ch=ch)
            stages_in.append((down,))
            chans.append(ch)
            ds *= 2

    mid: list[LLayer] = [res("middle_block.0", ch, ch)]
    if middle_attn and attn != "none":
        mid.append(attn_spec("middle_block.1", ch, len(channel_mult) - 1, nh))
        mid.append(res("middle_block.2", ch, ch))
    else:
        mid.append(res("middle_block.1", ch, ch))

    stages_out: list[Stage] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(nrb[level] + 1):
            ich = chans.pop()
            si = len(stages_out)
            st = [res(f"output_blocks.{si}.0", ch + ich, mc * mult)]
            ch = mc * mult
            j = 1
            if has_attn(level, i, ds):
                st.append(attn_spec(f"output_blocks.{si}.{j}", ch, level,
                                    num_heads_upsample))
                j += 1
            if level and i == nrb[level]:
                if resblock_updown:
                    st.append(LLayer("res_up", f"output_blocks.{si}.{j}",
                                     ch=ch, out_ch=ch,
                                     scale_shift=use_scale_shift_norm))
                elif conv_resample:
                    st.append(LLayer("up", f"output_blocks.{si}.{j}",
                                     ch=ch, out_ch=ch))
                else:
                    st.append(LLayer("nn_up", f"output_blocks.{si}.{j}",
                                     ch=ch, out_ch=ch))
                ds //= 2
            stages_out.append(tuple(st))
    return tuple(stages_in), tuple(mid), tuple(stages_out)


def build_fc_program(
    input_channels: int, model_channels: int,
    num_noattn_blocks, channel_mult: Sequence[int],
    with_attn: Sequence[bool], num_heads: int,
    second_dim: Sequence[int] | None,
) -> tuple[tuple[Stage, ...], Stage, tuple[Stage, ...], int]:
    """0-D programs. ``second_dim=None`` → UNetModel0D (openaimodel.py:
    2143-2275: scalar channels, real 1x1 convs + 3x3 downsamples on the
    [.,.,1,1] map); otherwise UNetModel0D_MultiDim (:2334-2451: flat
    [C*S] features, everything Linear). Returns (..., final flat width)."""
    md = second_dim is not None
    nrb = _normalize_res_blocks(num_noattn_blocks, channel_mult)
    mc = model_channels
    nh = num_heads
    if md:
        cur = (mc, second_dim[0])
        flat = lambda cs: cs[0] * cs[1]
        first = LLayer("lin_in", "input_blocks.0.0", ch=input_channels,
                       out_ch=flat(cur))
    else:
        cur = (mc, 1)
        flat = lambda cs: cs[0]
        first = LLayer("conv1_in", "input_blocks.0.0", ch=input_channels,
                       out_ch=mc)
    stages_in: list[Stage] = [(first,)]
    chans = [cur]
    dim_head = cur[0] // nh
    levels = list(zip(channel_mult, second_dim)) if md else \
        [(m, 1) for m in channel_mult]
    for level, (mult, sdim) in enumerate(levels):
        for _ in range(nrb[level]):
            i = len(stages_in)
            nxt = (mult * mc, sdim)
            st = [LLayer("fc", f"input_blocks.{i}.0", ch=flat(cur),
                         out_ch=flat(nxt))]
            cur = nxt
            dim_head = cur[0] // nh
            if with_attn[level]:
                st.append(LLayer("st", f"input_blocks.{i}.1", ch=cur[0],
                                 heads=nh, dim_head=dim_head))
            stages_in.append(tuple(st))
            chans.append(cur)
        if level != len(channel_mult) - 1:
            i = len(stages_in)
            kind = "lin" if md else "down0d"
            stages_in.append((LLayer(kind, f"input_blocks.{i}.0",
                                     ch=flat(cur), out_ch=flat(cur)),))
            chans.append(cur)

    mid = (LLayer("fc", "middle_block.0", ch=flat(cur), out_ch=flat(cur)),
           LLayer("st", "middle_block.1", ch=cur[0], heads=nh,
                  dim_head=dim_head),
           LLayer("fc", "middle_block.2", ch=flat(cur), out_ch=flat(cur)))

    stages_out: list[Stage] = []
    for level, (mult, sdim) in list(enumerate(levels))[::-1]:
        for i in range(nrb[level] + 1):
            extra = chans.pop()
            si = len(stages_out)
            nxt = (mult * mc, sdim)
            st = [LLayer("fc", f"output_blocks.{si}.0",
                         ch=flat(cur) + flat(extra), out_ch=flat(nxt))]
            cur = nxt
            j = 1
            if with_attn[level]:
                st.append(LLayer("st", f"output_blocks.{si}.{j}", ch=cur[0],
                                 heads=nh, dim_head=cur[0] // nh))
                j += 1
            if level != 0 and i == nrb[level]:
                kind = "lin" if md else "conv1"
                st.append(LLayer(kind, f"output_blocks.{si}.{j}",
                                 ch=flat(cur), out_ch=flat(cur)))
            stages_out.append(tuple(st))
    return tuple(stages_in), tuple(mid), tuple(stages_out), flat(cur)


# ---------------------------------------------------------------------------
# loading by rank
# ---------------------------------------------------------------------------

def weight_by_rank(key: str, value: torch.Tensor, shape) -> torch.Tensor:
    """A reference weight reshaped to the port's layer (``torch_convert.
    _transform``'s rule): [O, I], [O, I, 1] (a width-1 Conv1d) and
    [O, I, 1, 1] (a 1x1 Conv2d) are one matrix, loaded into a layer of
    either rank; a Conv1d of width other than 1 raises. Other mismatches
    are left for ``load_state_dict`` to report."""
    shape = tuple(shape)
    if tuple(value.shape) == shape:
        return value
    if value.dim() == 3 and value.shape[2] != 1:
        raise ValueError(f"{key}: conv1d kernel width {value.shape[2]} != 1 cannot map to "
                         f"a linear weight {shape}")
    unit = lambda s: len(s) in (2, 3, 4) and all(n == 1 for n in s[2:])
    if unit(tuple(value.shape)) and unit(shape) and tuple(value.shape[:2]) == shape[:2]:
        return value.reshape(shape)
    return value


def _load_by_rank(module, state_dict, prefix, *_):
    own = {prefix + k: v.shape for k, v in module.state_dict().items()}
    for key, shape in own.items():
        if key in state_dict and torch.is_tensor(state_dict[key]):
            state_dict[key] = weight_by_rank(key, state_dict[key], shape)


# ---------------------------------------------------------------------------
# walkers
# ---------------------------------------------------------------------------

_RES = ("res", "res_up", "res_down")


class _LegacyBase(nn.Module):
    """Module factory, stage runner and remat shared by the families."""

    use_checkpoint: bool = False
    dropout: float = 0.0

    def __init__(self):
        super().__init__()
        self._register_load_state_dict_pre_hook(_load_by_rank, with_module=True)

    def _remat(self, block: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _make(self, spec: LLayer, emb_dim: int, context_dim: int | None = None):
        k = spec.kind
        if k == "conv_in":
            return conv3(spec.ch, spec.out_ch, quant=False)
        if k in _RES:
            return LegacyResBlock(spec.ch, spec.out_ch, emb_dim, dropout=self.dropout,
                                  scale_shift=spec.scale_shift, up=k == "res_up",
                                  down=k == "res_down")
        if k == "st":
            return SpatialTransformer(spec.ch, spec.heads, spec.dim_head, context_dim,
                                      depth=spec.depth, disable_self_attn=spec.disable_self)
        if k == "dual":
            return DualSpatialTransformer(spec.ch, spec.heads, spec.dim_head, context_dim,
                                          depth=spec.depth, disable_self_attn=spec.disable_self)
        if k == "attn":
            return LegacyAttentionBlock(spec.ch, spec.heads, spec.new_order)
        if k in ("down", "down0d"):   # down0d: the 3x3 stride-2 conv on the [B, C, 1, 1] map
            return Downsample2D(spec.out_ch)
        if k == "up":
            return Upsample2D(spec.out_ch)
        if k == "pool":
            return _Resample(_avg_pool2)
        if k == "nn_up":
            return _Resample(_nn_up2)
        if k in ("lin_in", "lin"):
            return dense(spec.ch, spec.out_ch, quant=False)
        if k == "fc":
            return FCBlock(spec.ch, spec.out_ch, emb_dim)
        if k in ("conv1_in", "conv1"):
            return nn.Conv2d(spec.ch, spec.out_ch, 1)
        raise ValueError(k)

    def _stages(self, stages, emb_dim: int, context_dim: int | None = None) -> nn.ModuleList:
        return nn.ModuleList([nn.ModuleList([self._make(s, emb_dim, context_dim) for s in st])
                              for st in stages])

    @staticmethod
    def _tokens(h, spec: LLayer):
        """The stream state as the channel-first [B, C, N] view attention
        takes, and the map back."""
        if h.dim() == 4:
            b, c, hh, ww = h.shape
            return h.reshape(b, c, hh * ww), lambda t: t.reshape(b, c, hh, ww)
        b, f = h.shape   # flat 0-D stream, channel-major [B, C*S]
        return h.reshape(b, spec.ch, f // spec.ch), lambda t: t.reshape(b, f)

    def _run(self, specs, mods, h, emb, context, which_attn=None):
        for spec, mod in zip(specs, mods):
            k = spec.kind
            if k in _RES or k == "fc":
                h = self._remat(mod, h, emb)
            elif k == "attn":
                tok, restore = self._tokens(h, spec)
                h = restore(mod(tok))
            elif k in ("st", "dual"):
                tok, restore = self._tokens(h, spec)
                which = (which_attn,) if k == "dual" else ()
                h = restore(self._remat(mod, tok, context, *which))
            else:
                h = mod(h)
        return h

    def time_embedding(self, timesteps, dtype):
        return self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))


class LegacyConvUNet(_LegacyBase):
    """The classic input / middle / output UNet over ``build_conv_program``
    (ref forward: openaimodel.py:744-776)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320, out_channels: int = 4,
                 num_res_blocks: Any = 2, attention_resolutions: Sequence[int] = (),
                 with_attn: Sequence[bool] | None = None, dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 dims: int = 2, num_classes: int | None = None, use_checkpoint: bool = False,
                 use_fp16: bool = False, num_heads: int = -1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, use_new_attention_order: bool = False,
                 use_spatial_transformer: bool = False, transformer_depth: int = 1,
                 context_dim: int | None = None, n_embed: int | None = None,
                 legacy: bool = True, disable_self_attentions: Sequence[bool] | None = None,
                 num_attention_blocks: Sequence[int] | None = None,
                 image_size: int | None = None, with_time_embed: bool = True,
                 dual: bool = False, has_context: bool = True):
        super().__init__()
        if dims != 2:
            raise ValueError(f"legacy zoo: only 2-D conv variants ship (dims={dims})")
        if use_spatial_transformer and has_context and context_dim is None:
            raise ValueError("a spatial transformer with context needs context_dim")
        self.model_channels, self.num_classes, self.n_embed = model_channels, num_classes, n_embed
        self.dropout, self.use_checkpoint = dropout, use_checkpoint
        if not has_context and not attention_resolutions:
            attn = "none"
        elif use_spatial_transformer:
            attn = "dual" if dual else "st"
        else:
            attn = "self"
        self.program = build_conv_program(
            in_channels, model_channels, out_channels, num_res_blocks, tuple(channel_mult),
            attn=attn, attention_resolutions=tuple(attention_resolutions),
            with_attn=None if with_attn is None else tuple(with_attn),
            num_heads=num_heads, num_head_channels=num_head_channels,
            num_heads_upsample=num_heads_upsample, use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown, conv_resample=conv_resample,
            transformer_depth=transformer_depth,
            use_new_attention_order=use_new_attention_order, legacy=legacy,
            disable_self_attentions=disable_self_attentions,
            num_attention_blocks=num_attention_blocks)
        ins, mid, outs = self.program
        emb_dim = model_channels * 4
        ctx_dim = context_dim if has_context else None
        if with_time_embed:
            self.time_embed = TimeEmbedMLP(model_channels, emb_dim)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_dim)
        self.input_blocks = self._stages(ins, emb_dim, ctx_dim)
        self.middle_block = self._stages((mid,), emb_dim, ctx_dim)[0]
        self.output_blocks = self._stages(outs, emb_dim, ctx_dim)
        ch = model_channels * channel_mult[0]
        if n_embed is not None:
            self.id_predictor = nn.ModuleList([GroupNorm32(ch), nn.Conv2d(ch, n_embed, 1)])
        else:
            self.out = nn.ModuleList([GroupNorm32(ch), nn.Identity(),
                                      conv3(ch, out_channels, zero=True, quant=False)])

    def walk(self, x, emb, context=None, which_attn=None):
        ins, mid, outs = self.program
        hs, h = [], x
        for specs, mods in zip(ins, self.input_blocks):
            h = self._run(specs, mods, h, emb, context, which_attn)
            hs.append(h)
        h = self._run(mid, self.middle_block, h, emb, context, which_attn)
        for specs, mods in zip(outs, self.output_blocks):
            h = self._run(specs, mods, torch.cat([h, hs.pop()], dim=1), emb, context,
                          which_attn)
        return h

    def head(self, h):
        if self.n_embed is not None:
            return self.id_predictor[1](self.id_predictor[0](h))
        return self.out[2](self.out[0](h, silu=True))

    def forward(self, x, timesteps, context=None, y=None, which_attn=None):
        emb = self.time_embedding(timesteps, x.dtype)
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)
        return self.head(self.walk(x, emb, context, which_attn))


class LegacyUNetModel(LegacyConvUNet):
    """UNetModel (openaimodel.py:412-776): the SD v1 / guided-diffusion UNet."""


class LegacyUNetDualContext(LegacyConvUNet):
    """UNetModelDualContext (openaimodel.py:1621-1946; VD-DC): UNetModel with
    DualSpatialTransformer context layers and ``which_attn``."""

    def __init__(self, **kw):
        super().__init__(**{"dual": True, **kw})


class LegacyUNetNoContext(LegacyConvUNet):
    """UNetModelNoContext (openaimodel.py:1003-1286): attention without
    cross-context (a spatial transformer's attn2 is a self-attention)."""

    def __init__(self, **kw):
        super().__init__(**{"has_context": False, **kw})

    def forward(self, x, timesteps, context=None, y=None, which_attn=None):
        return super().forward(x, timesteps, None, y, None)


class LegacyUNetNoContextNoAtt(LegacyConvUNet):
    """UNetModelNoContextNoAtt (openaimodel.py:1287-1479): the res walk; the
    middle block is two ResBlocks."""

    def __init__(self, **kw):
        super().__init__(**{"has_context": False, "attention_resolutions": (), **kw})


class LegacyDecoderOnly(_LegacyBase):
    """UNetModelNoContextNoAttDecoderOnly (openaimodel.py:1480-1607): a
    sequential decoder (conv_in, res blocks and an upsample a level), no
    skips."""

    def __init__(self, in_channels: int = 4, out_channels: int = 3, model_channels: int = 64,
                 num_res_blocks: Any = 2, dropout: float = 0.0,
                 channel_mult: Sequence[int] = (4, 2, 1), conv_resample: bool = True,
                 dims: int = 2, num_classes: int | None = None, use_checkpoint: bool = False,
                 use_fp16: bool = False, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, n_embed: int | None = None):
        super().__init__()
        if dims != 2:
            raise ValueError(f"legacy zoo: only 2-D conv variants ship (dims={dims})")
        self.model_channels, self.dropout, self.use_checkpoint = (
            model_channels, dropout, use_checkpoint)
        nrb = _normalize_res_blocks(num_res_blocks, channel_mult)
        mc = model_channels
        ch = mc * channel_mult[0]
        stages: list[Stage] = [(LLayer("conv_in", "output_blocks.0.0",
                                       ch=in_channels, out_ch=ch),)]
        for level, mult in enumerate(channel_mult):
            for i in range(nrb[level]):
                si = len(stages)
                st = [LLayer("res", f"output_blocks.{si}.0", ch=ch, out_ch=mc * mult,
                             scale_shift=use_scale_shift_norm)]
                ch = mc * mult
                if level != len(channel_mult) - 1 and i == nrb[level] - 1:
                    kind = ("res_up" if resblock_updown else
                            "up" if conv_resample else "nn_up")
                    st.append(LLayer(kind, f"output_blocks.{si}.1", ch=ch, out_ch=ch,
                                     scale_shift=use_scale_shift_norm))
                stages.append(tuple(st))
        self.program = tuple(stages)
        self.time_embed = TimeEmbedMLP(mc, mc * 4)
        self.output_blocks = self._stages(self.program, mc * 4)
        self.out = nn.ModuleList([GroupNorm32(ch), nn.Identity(),
                                  conv3(ch, out_channels, zero=True, quant=False)])

    def forward(self, x, timesteps):
        emb = self.time_embedding(timesteps, x.dtype)
        h = x
        for specs, mods in zip(self.program, self.output_blocks):
            h = self._run(specs, mods, h, emb, None)
        return self.out[2](self.out[0](h, silu=True))


class LegacyUNet2D(LegacyConvUNet):
    """UNetModel2D (openaimodel.py:1948-2082): the pre-next image trunk,
    per-level ``with_attn``, spatial transformers on the context, dim_head =
    ch // num_heads. Registered through ``legacy_unet_2d``, which takes the
    reference's argument names."""

    def __init__(self, **kw):
        super().__init__(**{"use_spatial_transformer": True,
                            "with_attn": (True, True, True, False), "num_heads": 8,
                            "context_dim": 768, **kw})


def _remap_2d_args(kw: dict) -> dict:
    kw = dict(kw)
    for src, dst in (("input_channels", "in_channels"),
                     ("output_channels", "out_channels"),
                     ("num_noattn_blocks", "num_res_blocks")):
        if src in kw:
            kw[dst] = kw.pop(src)
    return kw


def legacy_unet_2d(**kw):
    """Builder taking the reference's UNetModel2D argument names."""
    return LegacyUNet2D(**_remap_2d_args(kw))


class LegacyFCUNet(_LegacyBase):
    """UNetModel0D / UNetModel0D_MultiDim (openaimodel.py:2143-2275,
    2334-2466). ``second_dim=None`` is the 0d variant: the state is the
    [B, C, 1, 1] map (its conv_in and downsamples are real convs);
    otherwise the flat channel-major [B, C*S]."""

    def __init__(self, input_channels: int = 768, model_channels: int = 320,
                 output_channels: int = 768, context_dim: int | None = 768,
                 num_noattn_blocks: Sequence[int] = (2, 2, 2, 2),
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 second_dim: Sequence[int] | None = None,
                 with_attn: Sequence[bool] = (True, True, True, False), num_heads: int = 8,
                 use_checkpoint: bool = False, with_time_embed: bool = True):
        super().__init__()
        self.model_channels, self.use_checkpoint = model_channels, use_checkpoint
        self.second_dim = None if second_dim is None else tuple(second_dim)
        ins, mid, outs, flat = build_fc_program(
            input_channels, model_channels, tuple(num_noattn_blocks), tuple(channel_mult),
            tuple(with_attn), num_heads, self.second_dim)
        self.program = (ins, mid, outs)
        emb_dim = model_channels * 4
        self.final_ch = channel_mult[0] * model_channels
        if with_time_embed:
            self.time_embed = TimeEmbedMLP(model_channels, emb_dim)
        self.input_blocks = self._stages(ins, emb_dim, context_dim)
        self.middle_block = self._stages((mid,), emb_dim, context_dim)[0]
        self.output_blocks = self._stages(outs, emb_dim, context_dim)
        head = (zero_init(nn.Conv2d(self.final_ch, output_channels, 1)) if second_dim is None
                else dense(flat, output_channels, zero=True, quant=False))
        self.out = nn.ModuleList([GroupNorm32(self.final_ch), nn.Identity(), head])

    def _run(self, specs, mods, h, emb, context, which_attn=None):
        if self.second_dim is None:   # the FC blocks take the [B, C, 1, 1] map flat
            for spec, mod in zip(specs, mods):
                if spec.kind == "fc":
                    b = h.shape[0]
                    h = self._remat(mod, h.reshape(b, -1), emb).reshape(b, -1, 1, 1)
                else:
                    h = super()._run((spec,), (mod,), h, emb, context)
            return h
        return super()._run(specs, mods, h, emb, context)

    def head(self, h):
        if self.second_dim is None:   # GN over C on the [B, C, 1, 1] map
            return self.out[2](self.out[0](h, silu=True))[:, :, 0, 0]
        b, f = h.shape                # GN over C (not flat) on [B, C, S]
        y = self.out[0](h.reshape(b, self.final_ch, f // self.final_ch), silu=True)
        return self.out[2](y.reshape(b, f))

    def forward(self, x, timesteps, context=None):
        """x: [B, C] (0d: the reference's [B, C, 1, 1] squeezed), or
        [B, C, 1, 1] for the 0d variant."""
        emb = self.time_embedding(timesteps, x.dtype)
        if self.second_dim is None and x.dim() == 2:
            x = x[:, :, None, None]
        ins, mid, outs = self.program
        hs, h = [], x
        for specs, mods in zip(ins, self.input_blocks):
            h = self._run(specs, mods, h, emb, context)
            hs.append(h)
        h = self._run(mid, self.middle_block, h, emb, context)
        for specs, mods in zip(outs, self.output_blocks):
            h = self._run(specs, mods, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.head(h)


class LegacyUNet0D(LegacyFCUNet):
    """UNetModel0D."""


class LegacyUNet0DMultiDim(LegacyFCUNet):
    """UNetModel0D_MultiDim: second_dim (4, 4, 4, 4) unless given."""

    def __init__(self, **kw):
        super().__init__(**{"second_dim": (4, 4, 4, 4), **kw})


class LegacyUNetVD(_LegacyBase):
    """UNetModelVD (openaimodel.py:2468-2566): zip-walks an image trunk
    (UNetModel2D) and a text trunk (UNetModel0D_MultiDim), each layer pair
    dispatched on (xtype, ctype), with one shared ``time_embed``.
    ``forward_dc`` blends two contexts at every context layer: h += r *
    (ctx0_layer(h) - h) + (1 - r) * (ctx1_layer(h) - h)."""

    def __init__(self, unet_image_cfg: dict, unet_text_cfg: dict):
        super().__init__()
        self.unet_image = LegacyUNet2D(**_remap_2d_args(dict(unet_image_cfg.get("args") or {})),
                                       with_time_embed=False)
        self.unet_text = LegacyUNet0DMultiDim(**dict(unet_text_cfg.get("args") or {}),
                                              with_time_embed=False)
        self.model_channels = self.unet_image.model_channels
        self.time_embed = TimeEmbedMLP(self.model_channels, self.model_channels * 4)

    def _run_pair(self, istage, tstage, h, emb, ctx_apply, xtype: str):
        """ctx_apply(h, active spec, image module, text module) runs the
        context layers; the data layers come from the ``xtype`` trunk."""
        trunk = self.unet_image if xtype == "image" else self.unet_text
        for (ispec, imod), (tspec, tmod) in zip(zip(*istage), zip(*tstage)):
            spec, mod = (ispec, imod) if xtype == "image" else (tspec, tmod)
            if ispec.kind == "st" or tspec.kind == "st":
                h = ctx_apply(h, spec, imod, tmod)
            else:
                h = trunk._run((spec,), (mod,), h, emb, None)
        return h

    def _walk(self, x, timesteps, ctx_apply, xtype: str):
        emb = self.time_embedding(timesteps, x.dtype)
        img, txt = self.unet_image, self.unet_text
        (i_in, i_mid, i_out), (t_in, t_mid, t_out) = img.program, txt.program
        hs, h = [], x   # image: the NCHW map; text: the flat [B, C]
        for ist, tst in zip(zip(i_in, img.input_blocks), zip(t_in, txt.input_blocks)):
            h = self._run_pair(ist, tst, h, emb, ctx_apply, xtype)
            hs.append(h)
        h = self._run_pair((i_mid, img.middle_block), (t_mid, txt.middle_block), h, emb,
                           ctx_apply, xtype)
        for ist, tst in zip(zip(i_out, img.output_blocks), zip(t_out, txt.output_blocks)):
            h = self._run_pair(ist, tst, torch.cat([h, hs.pop()], dim=1), emb, ctx_apply,
                               xtype)
        return txt.head(h) if xtype == "text" else img.head(h)

    def _context(self, mod, owner_is_image: bool, tok, context):
        owner = self.unet_image if owner_is_image else self.unet_text
        return owner._remat(mod, tok, context)

    def forward(self, x, timesteps, context, xtype: str = "image", ctype: str = "prompt"):
        def ctx_apply(h, spec, imod, tmod):
            tok, restore = self._tokens(h, spec)
            vision = ctype == "vision"
            return restore(self._context(imod if vision else tmod, vision, tok, context))
        return self._walk(x, timesteps, ctx_apply, xtype)

    def forward_dc(self, x, timesteps, c0, c1, xtype: str, c0_type: str, c1_type: str,
                   mixed_ratio):
        def ctx_apply(h, spec, imod, tmod):
            tok, restore = self._tokens(h, spec)
            v0, v1 = c0_type == "vision", c1_type == "vision"
            h0 = self._context(imod if v0 else tmod, v0, tok, c0) - tok
            h1 = self._context(imod if v1 else tmod, v1, tok, c1) - tok
            return restore(tok + h0 * mixed_ratio + h1 * (1.0 - mixed_ratio))
        return self._walk(x, timesteps, ctx_apply, xtype)

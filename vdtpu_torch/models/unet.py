"""Multi-flow UNet diffusers (``vdtpu/models/unet.py``): the 2-D image-latent
diffuser (NCHW) and the 0-D text-latent diffuser (flat channel-major
[B, C*S]).

The layer program (``build_program_2d`` / ``build_program_0d``) replays the
reference's construction order once; the forward walks its token sequence.
Data blocks and context blocks can come from different diffusers
(``run_tokens``): in the (image, text) flow the image diffuser supplies the
data blocks and the time embedding and the text diffuser the context blocks,
and the data stream's owner decides how its state becomes tokens
(``run_context(..., tokenizer=data_host)``).

Remat (``use_checkpoint``, the JAX package's ``UNetBase._remat``): while
autograd records, each ResBlock, FCBlock and SpatialTransformer of a
diffuser with ``use_checkpoint`` runs under
``torch.utils.checkpoint(use_reentrant=False)``, so the backward recomputes
the block's activations instead of keeping them; ``remat_max_channels``
limits it to blocks of at most that many channels (the high-resolution
levels, where most activation bytes live). Each diffuser's flag governs the
blocks it owns: the data blocks of the data diffuser, the context blocks
of the context diffuser. Forward values are the same either way.

Under int8 (``ops/quant.py``) ``conv_in`` (4 -> model channels) and the
output conv (model channels -> 4) are int8 sites like the ResBlock,
Downsample and Upsample convs, as in the JAX package; the time-embed MLP
is not. With token merging, each walk (``walk``, and
``MultiDiffuser.apply_flow_multicontext`` over all its context stacks)
makes one ``ToMeWalk`` and hands it to every context block, so the merge
built at a walk's first long site is reused by the later ones of that size
and dropped with the walk.

Encoder reuse splits a walk in two (``walk_encoder``: the input half,
returning h and the skip stack; ``walk_decoder``: the mid and output walk
from them). Each half is a walk of its own, with its own ``ToMeWalk``, as
in the JAX package; the two halves in turn give ``walk``'s result.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vdtpu_torch.models.blocks import FCBlock, ResBlock2D
from vdtpu_torch.models.layers import (
    Downsample2D, GroupNorm32, TimeEmbedMLP, Upsample2D, conv3, dense)
from vdtpu_torch.models.transformer import SpatialTransformer
from vdtpu_torch.ops.schedules import timestep_embedding
from vdtpu_torch.ops.tome import ToMeSpec, ToMeWalk

SAVE, LOAD, D, C = "save", "load", "d", "c"


@dataclasses.dataclass(frozen=True)
class DataSpec:
    name: str       # torch state-dict prefix, e.g. "data_blocks.3.0"
    kind: str       # conv_in|res|down|up|out | linear_in|fc|linear|out0d
    in_ch: int
    out_ch: int


@dataclasses.dataclass(frozen=True)
class CtxSpec:
    name: str
    channels: int
    heads: int
    dim_head: int


@dataclasses.dataclass(frozen=True)
class UNetProgram:
    data: tuple[DataSpec, ...]
    ctx: tuple[CtxSpec, ...]
    i_order: tuple[str, ...]
    m_order: tuple[str, ...]
    o_order: tuple[str, ...]

    @property
    def layer_order(self) -> tuple[str, ...]:
        return self.i_order + self.m_order + self.o_order


def _heads(ch: int, num_heads, num_head_channels) -> tuple[int, int]:
    if num_head_channels is None:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


class _ProgramBuilder:
    def __init__(self, num_heads, num_head_channels):
        self.data: list[DataSpec] = []
        self.ctx: list[CtxSpec] = []
        self.order: list[str] = []
        self.num_heads = num_heads
        self.num_head_channels = num_head_channels

    def add_d(self, kind, in_ch, out_ch):
        self.data.append(DataSpec(f"data_blocks.{len(self.data)}.0", kind, in_ch, out_ch))
        self.order.append(D)

    def add_c(self, ch):
        h, dh = _heads(ch, self.num_heads, self.num_head_channels)
        self.ctx.append(CtxSpec(f"context_blocks.{len(self.ctx)}.0", ch, h, dh))
        self.order.append(C)

    def take_order(self):
        out, self.order = tuple(self.order), []
        return out


def build_program_2d(in_channels: int, model_channels: int, out_channels: int,
                     num_res_blocks: Sequence[int], attention_resolutions: Sequence[int],
                     channel_mult: Sequence[int], num_heads: int | None,
                     num_head_channels: int | None = None) -> UNetProgram:
    """The reference's 2-D construction order (openaimodel.py:2664-2741)."""
    b = _ProgramBuilder(num_heads, num_head_channels)
    mc = model_channels
    b.add_d("conv_in", in_channels, mc)
    b.order.append(SAVE)
    chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks[level]):
            b.add_d("res", ch, mult * mc)
            ch = mult * mc
            if ds in attention_resolutions:
                b.add_c(ch)
            chans.append(ch)
            b.order.append(SAVE)
        if level != len(channel_mult) - 1:
            b.add_d("down", ch, ch)
            chans.append(ch)
            b.order.append(SAVE)
            ds *= 2
    i_order = b.take_order()

    b.add_d("res", ch, ch)
    b.add_c(ch)
    b.add_d("res", ch, ch)
    m_order = b.take_order()

    for level, mult in list(enumerate(channel_mult))[::-1]:
        for _ in range(num_res_blocks[level] + 1):
            b.order.append(LOAD)
            ich = chans.pop()
            b.add_d("res", ch + ich, mc * mult)
            ch = mc * mult
            if ds in attention_resolutions:
                b.add_c(ch)
        if level != 0:
            b.add_d("up", ch, ch)
            ds //= 2
    b.add_d("out", ch, out_channels)
    o_order = b.take_order()
    return UNetProgram(tuple(b.data), tuple(b.ctx), i_order, m_order, o_order)


def build_program_0d(input_channels: int, model_channels: int, output_channels: int,
                     num_noattn_blocks: Sequence[int], channel_mult: Sequence[int],
                     second_dim: Sequence[int], with_attn: Sequence[bool],
                     num_heads: int | None, num_head_channels: int | None = None
                     ) -> UNetProgram:
    """The reference's 0-D construction order (openaimodel.py:2885-2963).
    Data specs carry flat feature sizes (C*S); ctx specs the channel count C."""
    b = _ProgramBuilder(num_heads, num_head_channels)
    mc = model_channels
    cur = (mc, second_dim[0])  # (C, S)
    flat = lambda cs: cs[0] * cs[1]
    b.add_d("linear_in", input_channels, flat(cur))
    b.order.append(SAVE)
    chans = [cur]
    for level, (mult, sdim) in enumerate(zip(channel_mult, second_dim)):
        for _ in range(num_noattn_blocks[level]):
            nxt = (mult * mc, sdim)
            b.add_d("fc", flat(cur), flat(nxt))
            cur = nxt
            if with_attn[level]:
                b.add_c(cur[0])
            chans.append(cur)
            b.order.append(SAVE)
        if level != len(channel_mult) - 1:
            b.add_d("linear", flat(cur), flat(cur))
            chans.append(cur)
            b.order.append(SAVE)
    i_order = b.take_order()

    b.add_d("fc", flat(cur), flat(cur))
    b.add_c(cur[0])
    b.add_d("fc", flat(cur), flat(cur))
    m_order = b.take_order()

    for level, (mult, sdim) in list(enumerate(zip(channel_mult, second_dim)))[::-1]:
        for _ in range(num_noattn_blocks[level] + 1):
            b.order.append(LOAD)
            extra = chans.pop()
            nxt = (mult * mc, sdim)
            b.add_d("fc", flat(cur) + flat(extra), flat(nxt))
            cur = nxt
            if with_attn[level]:
                b.add_c(cur[0])
        if level != 0:
            b.add_d("linear", flat(cur), flat(cur))
    b.add_d("out0d", flat(cur), output_channels)
    o_order = b.take_order()
    return UNetProgram(tuple(b.data), tuple(b.ctx), i_order, m_order, o_order)


class _Out2D(nn.Module):
    """Final GN -> SiLU -> zero conv3 (keys 0 / 2)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.add_module("0", GroupNorm32(channels))
        self.add_module("2", conv3(channels, out_channels, zero=True))

    def forward(self, x):
        return self._modules["2"](self._modules["0"](x, silu=True))


class _Out0D(nn.Module):
    """Final per-channel GN over [B, C, S] -> SiLU -> zero Dense(C*S -> out)."""

    def __init__(self, channels: int, second_dim: int, flat_in: int, out_channels: int):
        super().__init__()
        self.channels, self.second_dim = channels, second_dim
        self.add_module("0", GroupNorm32(channels))
        self.add_module("2", dense(flat_in, out_channels, zero=True))

    def forward(self, x):
        b = x.shape[0]
        h = self._modules["0"](x.reshape(b, self.channels, self.second_dim), silu=True)
        return self._modules["2"](h.reshape(b, -1))


class UNetBase(nn.Module):
    """Module construction and the program walk shared by both diffusers."""

    program: UNetProgram
    model_channels: int
    use_checkpoint: bool = False
    remat_max_channels: int | None = None

    def _remat(self, block: nn.Module, channels: int, *args):
        """block(*args), rematerialized in the backward where remat applies."""
        if (self.use_checkpoint and torch.is_grad_enabled()
                and (self.remat_max_channels is None or channels <= self.remat_max_channels)):
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _build(self, parts: Sequence[str], context_dim: int):
        emb_dim = self.model_channels * 4
        if "global" in parts:
            self.time_embed = TimeEmbedMLP(self.model_channels, emb_dim)
        if "data" in parts:
            self.data_blocks = nn.ModuleList(
                [nn.ModuleList([self._make_data_module(s, emb_dim)])
                 for s in self.program.data])
        if "context" in parts:
            self.context_blocks = nn.ModuleList(
                [nn.ModuleList([SpatialTransformer(s.channels, s.heads, s.dim_head,
                                                   context_dim)])
                 for s in self.program.ctx])

    def _make_data_module(self, spec: DataSpec, emb_dim: int) -> nn.Module:
        if spec.kind == "conv_in":
            return conv3(spec.in_ch, spec.out_ch)
        if spec.kind == "res":
            return ResBlock2D(spec.in_ch, spec.out_ch, emb_dim)
        if spec.kind == "down":
            return Downsample2D(spec.out_ch)
        if spec.kind == "up":
            return Upsample2D(spec.out_ch)
        if spec.kind == "out":
            return _Out2D(spec.in_ch, spec.out_ch)
        if spec.kind in ("linear_in", "linear"):
            return dense(spec.in_ch, spec.out_ch)
        if spec.kind == "fc":
            return FCBlock(spec.in_ch, spec.out_ch, emb_dim)
        if spec.kind == "out0d":
            c = self.current_out_channels()
            return _Out0D(c, self.second_dim[0], spec.in_ch, spec.out_ch)
        raise ValueError(spec.kind)

    def time_embedding(self, timesteps, dtype):
        return self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))

    def run_data(self, i: int, h, emb):
        mod = self.data_blocks[i][0]
        spec = self.program.data[i]
        if spec.kind in ("res", "fc"):
            return self._remat(mod, spec.out_ch, h, emb)
        return mod(h)

    def run_context(self, i: int, h, ctx, tokenizer: "UNetBase | None" = None,
                    tome: ToMeWalk | None = None):
        """Context block i on h; ``tokenizer`` is the diffuser that owns the
        data stream (its layout decides the tokens)."""
        x_cf, restore = (tokenizer or self).channel_first(h, i)
        block = self.context_blocks[i][0]
        return restore(self._remat(block, self.program.ctx[i].channels, x_cf, ctx, tome))

    def run_tokens(self, tokens, h, emb, context_step, data_host: "UNetBase | None" = None,
                   hs=(), di: int = 0, ci: int = 0, return_skips: bool = False):
        """Walk ``tokens`` from h: data blocks of ``data_host`` (default
        self) from data slot ``di``, ``context_step(ci, h)`` from context
        slot ``ci``, skip saves onto and concatenating loads from the stack
        ``hs``. Returns h, or (h, the skip stack) with ``return_skips``."""
        data_host = data_host or self
        hs = list(hs)
        for token in tokens:
            if token == D:
                h = data_host.run_data(di, h, emb)
                di += 1
            elif token == C:
                h = context_step(ci, h)
                ci += 1
            elif token == SAVE:
                hs.append(h)
            elif token == LOAD:
                h = torch.cat([h, hs.pop()], dim=1)
        return (h, tuple(hs)) if return_skips else h

    def _encoder_counts(self) -> tuple[int, int]:
        """(data blocks, context blocks) of the input half (i_order): the
        slots the mid and output walk starts from."""
        order = self.program.i_order
        return order.count(D), order.count(C)

    @staticmethod
    def _context_step(context, data_host: "UNetBase", ctx_host: "UNetBase",
                      tome: ToMeSpec | None):
        """context_step of one walk over ``ctx_host``'s context blocks, with
        its own ``ToMeWalk``."""
        tome_walk = tome and ToMeWalk(tome)
        return lambda ci, h: ctx_host.run_context(ci, h, context, tokenizer=data_host,
                                                  tome=tome_walk)

    def walk(self, x, emb, context, data_host: "UNetBase", ctx_host: "UNetBase",
             tome: ToMeSpec | None = None):
        return self.run_tokens(self.program.layer_order, x, emb,
                               self._context_step(context, data_host, ctx_host, tome),
                               data_host)

    def walk_encoder(self, x, emb, context, data_host: "UNetBase", ctx_host: "UNetBase",
                     tome: ToMeSpec | None = None):
        """The input half (i_order): (h, skip stack), the state that encoder
        reuse keeps between key steps."""
        return self.run_tokens(self.program.i_order, x, emb,
                               self._context_step(context, data_host, ctx_host, tome),
                               data_host, return_skips=True)

    def walk_decoder(self, h, hs, emb, context, data_host: "UNetBase", ctx_host: "UNetBase",
                     tome: ToMeSpec | None = None):
        """The mid and output walk from an input half's (h, skip stack)."""
        di, ci = self._encoder_counts()
        return self.run_tokens(self.program.m_order + self.program.o_order, h, emb,
                               self._context_step(context, data_host, ctx_host, tome),
                               data_host, hs=hs, di=di, ci=ci)


class UNet2DNext(UNetBase):
    """Image-latent diffuser, NCHW."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320, out_channels: int = 4,
                 num_res_blocks: Sequence[int] = (2, 2, 2, 2),
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int | None = 8,
                 num_head_channels: int | None = None, context_dim: int = 768,
                 parts: Sequence[str] = ("global", "data", "context"),
                 use_checkpoint: bool = False, remat_max_channels: int | None = None,
                 **_unused):
        super().__init__()
        self.model_channels = model_channels
        self.use_checkpoint, self.remat_max_channels = use_checkpoint, remat_max_channels
        self.program = build_program_2d(
            in_channels, model_channels, out_channels, tuple(num_res_blocks),
            tuple(attention_resolutions), tuple(channel_mult), num_heads, num_head_channels)
        self._build(parts, context_dim)

    def channel_first(self, h, ci: int = 0):
        b, c, hh, ww = h.shape
        return h.reshape(b, c, hh * ww), lambda t: t.reshape(b, c, hh, ww)


class UNet0DNext(UNetBase):
    """Text-latent diffuser on flat channel-major [B, C*S] features."""

    def __init__(self, input_channels: int = 768, model_channels: int = 320,
                 output_channels: int = 768, num_noattn_blocks: Sequence[int] = (2, 2, 2, 2),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 second_dim: Sequence[int] = (4, 4, 4, 4),
                 with_attn: Sequence[bool] = (True, True, True, False),
                 num_heads: int | None = 8, num_head_channels: int | None = None,
                 context_dim: int = 768,
                 parts: Sequence[str] = ("global", "data", "context"),
                 use_checkpoint: bool = False, remat_max_channels: int | None = None,
                 **_unused):
        super().__init__()
        self.model_channels = model_channels
        self.use_checkpoint, self.remat_max_channels = use_checkpoint, remat_max_channels
        self.channel_mult = tuple(channel_mult)
        self.second_dim = tuple(second_dim)
        self.program = build_program_0d(
            input_channels, model_channels, output_channels, tuple(num_noattn_blocks),
            tuple(channel_mult), tuple(second_dim), tuple(with_attn), num_heads,
            num_head_channels)
        self._build(parts, context_dim)

    def current_out_channels(self) -> int:
        return self.channel_mult[0] * self.model_channels

    def channel_first(self, h, ci: int = 0):
        # [B, C*S] channel-major is [B, C, S]; C at slot ci comes from the program
        b, f = h.shape
        c = self.program.ctx[ci].channels
        return h.reshape(b, c, f // c), lambda t: t.reshape(b, f)

"""CLIP ViT-L/14 context encoders, text and vision (``vdtpu/models/clip.py``).

HF ``CLIPModel`` state-dict names: ``text_model.*`` plus
``text_projection``; ``vision_model.*`` (``embeddings.patch_embedding``
without bias, ``embeddings.class_embedding``,
``embeddings.position_embedding``, HF's ``pre_layrnorm`` spelling,
``post_layernorm``) plus ``visual_projection``. VD's text context is the
projected token states divided by the norm of the projected EOT-pooled
state (EOT = argmax of the ids, the CLIP convention); its image context is
the post-LayerNorm, projected tokens divided by the norm of the projected
CLS token. ``preprocess_images`` is CLIPProcessor's bicubic shortest-side
resize, centre crop and mean/std normalization. The masked image context
takes a per-token mask (``vision_token_mask``: the pixel mask averaged
over each patch, and its global mean for the CLS token) and applies it
twice, as the JAX package does: to the embeddings before ``pre_layrnorm``
and to the normalized context.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vdtpu_torch.models.layers import LayerNorm, dense
from vdtpu_torch.ops.attention import scaled_dot_product_attention
from vdtpu_torch.ops.resize import resize


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    hidden: int
    layers: int
    heads: int
    intermediate: int


TEXT_L14 = CLIPTowerConfig(hidden=768, layers=12, heads=12, intermediate=3072)
VISION_L14 = CLIPTowerConfig(hidden=1024, layers=24, heads=16, intermediate=4096)
PROJECTION_DIM = 768
VOCAB_SIZE = 49408
MAX_TEXT_LEN = 77
IMAGE_SIZE = 224
PATCH = 14

CLIP_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.heads = cfg.heads
        self.q_proj = dense(cfg.hidden, cfg.hidden, quant=False)
        self.k_proj = dense(cfg.hidden, cfg.hidden, quant=False)
        self.v_proj = dense(cfg.hidden, cfg.hidden, quant=False)
        self.out_proj = dense(cfg.hidden, cfg.hidden, quant=False)

    def forward(self, h, mask):
        b, n, c = h.shape
        hd = c // self.heads
        shape = lambda t: t.view(b, n, self.heads, hd)
        q = self.q_proj(h) * hd ** -0.5
        attn = scaled_dot_product_attention(shape(q), shape(self.k_proj(h)),
                                            shape(self.v_proj(h)), mask=mask, scale=1.0)
        return self.out_proj(attn.reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.fc1 = dense(cfg.hidden, cfg.intermediate, quant=False)
        self.fc2 = dense(cfg.intermediate, cfg.hidden, quant=False)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden, eps=1e-5)
        self.self_attn = _SelfAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden, eps=1e-5)
        self.mlp = _MLP(cfg)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, max_len: int, hidden: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden)
        self.position_embedding = nn.Embedding(max_len, hidden)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.layers)])


class CLIPTextTower(nn.Module):
    """Token + position embeddings, causal encoder layers, final LayerNorm."""

    def __init__(self, cfg: CLIPTowerConfig = TEXT_L14, vocab_size: int = VOCAB_SIZE,
                 max_len: int = MAX_TEXT_LEN):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, max_len, cfg.hidden)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden, eps=1e-5)

    def forward(self, input_ids):
        n = input_ids.shape[1]
        emb = self.embeddings
        pos = torch.arange(n, device=input_ids.device)
        x = emb.token_embedding(input_ids) + emb.position_embedding(pos)[None]
        causal = torch.ones((n, n), dtype=torch.bool, device=input_ids.device).tril()
        for layer in self.encoder.layers:
            x = layer(x, mask=causal)
        return self.final_layer_norm(x)


class CLIPTextContextEncoder(nn.Module):
    """ids [B, L] -> context [B, L, projection_dim]."""

    def __init__(self, tower=TEXT_L14, vocab_size: int = VOCAB_SIZE,
                 max_len: int = MAX_TEXT_LEN, projection_dim: int = PROJECTION_DIM):
        super().__init__()
        tower = tower if isinstance(tower, CLIPTowerConfig) else CLIPTowerConfig(**tower)
        self.max_len = max_len
        self.text_model = CLIPTextTower(tower, vocab_size, max_len)
        self.text_projection = dense(tower.hidden, projection_dim, bias=False, quant=False)

    def forward(self, input_ids):
        hidden = self.text_model(input_ids)
        z = self.text_projection(hidden)
        eot = input_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
        norm = self.text_projection(pooled).float().norm(dim=-1, keepdim=True)
        return z / norm[:, None, :].to(z.dtype)


class _VisionEmbeddings(nn.Module):
    def __init__(self, hidden: int, image_size: int, patch: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(hidden))
        self.class_embedding.init_std = 0.02  # flax normal(0.02)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, hidden)

    def forward(self, pixels):
        """pixels [B, H, W, 3] (normalized) -> [B, 1 + P, hidden]."""
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[None, :x.shape[1]]


class CLIPVisionTower(nn.Module):
    """Patch + class + position embeddings, pre-LayerNorm, the encoder
    layers; returns the hidden states before ``post_layernorm`` (which the
    tower holds, under HF's name, and the context encoder applies)."""

    def __init__(self, cfg: CLIPTowerConfig = VISION_L14, image_size: int = IMAGE_SIZE,
                 patch: int = PATCH):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg.hidden, image_size, patch)
        self.pre_layrnorm = LayerNorm(cfg.hidden, eps=1e-5)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden, eps=1e-5)

    def forward(self, pixels, token_mask=None):
        """``token_mask`` [B, 1 + P, 1] scales the embeddings (None: no mask)."""
        x = self.embeddings(pixels)
        if token_mask is not None:
            x = x * token_mask.to(x.dtype)
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class CLIPImageContextEncoder(nn.Module):
    """Normalized pixels [B, S, S, 3] -> context [B, 1 + P, projection_dim];
    with ``token_mask`` [B, 1 + P, 1] the masked context."""

    def __init__(self, tower=VISION_L14, image_size: int = IMAGE_SIZE, patch: int = PATCH,
                 projection_dim: int = PROJECTION_DIM):
        super().__init__()
        tower = tower if isinstance(tower, CLIPTowerConfig) else CLIPTowerConfig(**tower)
        self.image_size, self.patch = image_size, patch
        self.vision_model = CLIPVisionTower(tower, image_size, patch)
        self.visual_projection = dense(tower.hidden, projection_dim, bias=False, quant=False)

    def forward(self, pixels, token_mask=None):
        hidden = self.vision_model(pixels, token_mask)
        z = self.visual_projection(self.vision_model.post_layernorm(hidden))
        norm = z[:, 0:1].float().norm(dim=-1, keepdim=True)
        z = z / norm.to(z.dtype)
        return z if token_mask is None else z * token_mask.to(z.dtype)


def vision_token_mask(masks, patch: int = PATCH):
    """Pixel mask [B, S, S, 1] -> per-token mask [B, 1 + P, 1] in f32: the
    mask clamped to [0, 1], averaged over each patch, with its global mean
    as the CLS entry."""
    m = torch.as_tensor(masks).float().clamp(0.0, 1.0)
    b, h, w, _ = m.shape
    gscale = m.mean(dim=(1, 2, 3)).reshape(b, 1, 1)
    pooled = m.reshape(b, h // patch, patch, w // patch, patch).mean(dim=(2, 4))
    return torch.cat([gscale, pooled.reshape(b, -1, 1)], dim=1)


def preprocess_images(images, size: int = IMAGE_SIZE):
    """[B, H, W, 3] in [0, 1] -> CLIP-normalized f32 [B, size, size, 3]:
    bicubic resize of the shortest side to ``size``, centre crop, mean/std."""
    x = torch.as_tensor(images).float()
    _, h, w, _ = x.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = resize(x, (nh, nw))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size, :]
    mean, std = (torch.as_tensor(a, device=x.device) for a in (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD))
    return (x - mean) / std

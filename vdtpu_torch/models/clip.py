"""CLIP ViT-L/14 text context encoder (``vdtpu/models/clip.py``).

HF ``CLIPModel`` state-dict names under ``text_model.*`` plus
``text_projection``. VD's text context is the projected token states
divided by the norm of the projected EOT-pooled state (EOT = argmax of the
ids, the CLIP convention).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vdtpu_torch.models.layers import LayerNorm, dense
from vdtpu_torch.ops.attention import scaled_dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    hidden: int
    layers: int
    heads: int
    intermediate: int


TEXT_L14 = CLIPTowerConfig(hidden=768, layers=12, heads=12, intermediate=3072)
PROJECTION_DIM = 768
VOCAB_SIZE = 49408
MAX_TEXT_LEN = 77


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

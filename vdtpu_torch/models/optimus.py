"""Optimus text VAE (``vdtpu/models/optimus.py``): a BERT encoder to a
768-d latent, and a GPT-2 decoder that samples text from it.

- Encode: ids (lowercased wordpieces, 0-padded) -> BERT -> the [CLS]
  state -> ``pooler.dense`` -> tanh -> ``linear`` (no bias) -> (mu, logvar);
  inference returns mu.
- Decode: GPT-2 with the latent injected twice, as a length-1 key/value
  memory in front of every layer's attention (``transformer.linear``:
  latent -> n_layer * hidden) and as an offset added to every token's
  embedding (``transformer.linear_emb``); the LM head is tied to ``wte``.
  ``generate`` samples a fixed ``max_length - 1`` steps over a static KV
  cache, as the JAX package's ``lax.scan`` does.

Parameter names are the reference state dict's, so the JAX package's
``export_torch_checkpoint()`` loads with ``strict=True`` under
``vae.text.``. GPT-2's four projections are ``Conv1D``s: weight [in, out],
y = x @ W + b (a Linear-convention module would load a square ``c_proj``
without complaint and apply its transpose).

Sampling is a Gumbel-max draw, argmax(logits_f32 + g) with g = -log(-log
u), which is what ``jax.random.categorical`` computes; ``g`` comes from the
caller's ``torch.Generator`` (one for the batch, or one per row) or from a
given ``gumbel_table`` [max_length - 1, B, V], which lets a test replay the
JAX package's draws. Sequences here are at most 77 tokens (BERT) and 31
cache slots (GPT-2), so every attention takes the plain path.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.layers import LayerNorm
from vdtpu_torch.ops.attention import plain_attention

# GPT-2 vocabulary with Optimus' specials: 50257 base + <PAD>, <BOS>, <EOS>
GPT2_PAD, GPT2_BOS, GPT2_EOS = 50257, 50258, 50259
MAX_DECODE_LEN = 30


def _container(**modules) -> nn.Module:
    """An empty module holding ``modules`` (a level of the state-dict path)."""
    m = nn.Module()
    for k, v in modules.items():
        setattr(m, k, v)
    return m


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        h = cfg["hidden_size"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], h)
        self.LayerNorm = LayerNorm(h, eps=float(cfg.get("layer_norm_eps", 1e-12)))

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class BertLayer(nn.Module):
    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        h, inter = cfg["hidden_size"], cfg["intermediate_size"]
        eps = float(cfg.get("layer_norm_eps", 1e-12))
        self.heads = cfg["num_attention_heads"]
        self.attention = _container(
            self=_container(query=nn.Linear(h, h), key=nn.Linear(h, h), value=nn.Linear(h, h)),
            output=_container(dense=nn.Linear(h, h), LayerNorm=LayerNorm(h, eps=eps)))
        self.intermediate = _container(dense=nn.Linear(h, inter))
        self.output = _container(dense=nn.Linear(inter, h), LayerNorm=LayerNorm(h, eps=eps))

    def forward(self, x, mask):
        b, n, h = x.shape
        sa = self.attention.self
        sh = lambda t: t.reshape(b, n, self.heads, h // self.heads)
        a = plain_attention(sh(sa.query(x)), sh(sa.key(x)), sh(sa.value(x)), mask,
                            (h // self.heads) ** -0.5)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(a.reshape(b, n, h)))
        y = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class OptimusBertConnector(nn.Module):
    """BERT tower + pooler + (mu, logvar) head; forward returns [B, 2 * latent]."""

    def __init__(self, config: Mapping[str, Any], latent_size: int = 768):
        super().__init__()
        c = dict(config)
        self.embeddings = BertEmbeddings(c)
        self.encoder = _container(layer=nn.ModuleList(
            BertLayer(c) for _ in range(c["num_hidden_layers"])))
        self.pooler = _container(dense=nn.Linear(c["hidden_size"], c["hidden_size"]))
        self.linear = nn.Linear(c["hidden_size"], 2 * latent_size, bias=False)

    def forward(self, input_ids):
        mask = (input_ids > 0)[:, None, None, :]   # keep-mask over the keys
        x = self.embeddings(input_ids)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return self.linear(torch.tanh(self.pooler.dense(x[:, 0])))


class Conv1D(nn.Module):
    """GPT-2's projection: weight [in, out], y = x @ W + b."""

    def __init__(self, nx: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nx, nf))
        self.weight.init_std = nx ** -0.5   # lecun-normal over the input axis
        self.bias = nn.Parameter(torch.zeros(nf))

    def forward(self, x):
        return x @ self.weight + self.bias


class GPT2Block(nn.Module):
    """Pre-LN GPT-2 block; the latent memory enters the attention as a key
    and value as it is (not projected)."""

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        h = cfg["n_embd"]
        eps = float(cfg.get("layer_norm_epsilon", 1e-5))
        self.heads, self.hsz = cfg["n_head"], h
        self.ln_1 = LayerNorm(h, eps=eps)
        self.attn = _container(c_attn=Conv1D(h, 3 * h), c_proj=Conv1D(h, h))
        self.ln_2 = LayerNorm(h, eps=eps)
        self.mlp = _container(c_fc=Conv1D(h, 4 * h), c_proj=Conv1D(4 * h, h))

    def _split(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.hsz // self.heads)

    def qkv(self, x):
        return self.attn.c_attn(self.ln_1(x)).chunk(3, dim=-1)

    def _attend(self, q, k, v, mask):
        a = plain_attention(self._split(q), self._split(k), self._split(v), mask,
                            (self.hsz // self.heads) ** -0.5)
        return a.reshape(q.shape)

    def finish(self, x, attn_out):
        x = x + self.attn.c_proj(attn_out)
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x)), approximate="tanh"))

    def forward(self, x, latent_kv, mask):
        """Teacher-forced: latent_kv [B, 1, hidden] is key and value slot 0."""
        q, k, v = self.qkv(x)
        k, v = torch.cat([latent_kv, k], dim=1), torch.cat([latent_kv, v], dim=1)
        return self.finish(x, self._attend(q, k, v, mask))

    def decode_step(self, x, k_cache, v_cache, pos: int):
        """One token x [B, 1, hidden] at position ``pos``; the caches [B, T,
        hidden] hold the latent in slot 0 and token i in slot i + 1, and are
        written in place."""
        q, k, v = self.qkv(x)
        k_cache[:, pos + 1] = k[:, 0]
        v_cache[:, pos + 1] = v[:, 0]
        keep = (torch.arange(k_cache.shape[1], device=x.device) <= pos + 1)[None, None, None]
        return self.finish(x, self._attend(q, k_cache, v_cache, keep))


class OptimusGPT2Connector(nn.Module):
    """GPT-2 LM with latent memory and embedding injection."""

    def __init__(self, config: Mapping[str, Any]):
        super().__init__()
        c = dict(config)
        h, self.n_layer = c["n_embd"], c["n_layer"]
        self.transformer = _container(
            wte=nn.Embedding(c["vocab_size"], h), wpe=nn.Embedding(c["n_positions"], h),
            h=nn.ModuleList(GPT2Block(c) for _ in range(self.n_layer)),
            ln_f=LayerNorm(h, eps=float(c.get("layer_norm_epsilon", 1e-5))),
            linear=nn.Linear(c["latent_size"], h * self.n_layer, bias=False),
            linear_emb=nn.Linear(c["latent_size"], h, bias=False))

    def _logits(self, h):
        return self.transformer.ln_f(h) @ self.transformer.wte.weight.t()

    def _latents(self, z):
        """(per-layer memory [B, 1, hidden] each, embedding offset [B, hidden])."""
        z = z.to(self.transformer.linear.weight.dtype)
        mems = self.transformer.linear(z).chunk(self.n_layer, dim=-1)
        return [m[:, None] for m in mems], self.transformer.linear_emb(z)

    def forward(self, input_ids, z):
        """Teacher-forced logits [B, N, V]; token i sits at position i + 1
        (the latent memory is position 0)."""
        n = input_ids.shape[1]
        mems, emb_off = self._latents(z)
        t = self.transformer
        pos = torch.arange(1, n + 1, device=input_ids.device)
        h = t.wte(input_ids) + t.wpe(pos)[None] + emb_off[:, None]
        causal = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
        mask = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=h.device), causal],
                         dim=1)[None, None]
        for blk, mem in zip(t.h, mems):
            h = blk(h, mem, mask)
        return self._logits(h)

    def generate(self, z, generator=None, max_length: int = MAX_DECODE_LEN,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token: int = GPT2_EOS, bos_token: int = GPT2_BOS, gumbel_table=None):
        """Token ids [B, max_length] starting with BOS; after a row's first
        EOS every position is EOS, and EOS is forced at the last two steps.

        The draws: ``gumbel_table`` [max_length - 1, B, V] if given, else
        from ``generator``: one ``torch.Generator`` draws each step's [B, V]
        (the batch shares one stream, as the JAX package's single key), or a
        sequence of B generators draws each row's [V] from its own stream
        (the JAX package's [B, 2] per-row keys: a row's text does not
        depend on its co-riders)."""
        b = z.shape[0]
        t = self.transformer
        dev, dt = t.wte.weight.device, t.wte.weight.dtype
        mems, emb_off = self._latents(z.to(dev))
        cache = torch.zeros(2, self.n_layer, b, max_length + 1, emb_off.shape[-1],
                            dtype=dt, device=dev)
        for i, m in enumerate(mems):
            cache[:, i, :, 0] = m[:, 0]
        per_row = isinstance(generator, Sequence)
        if per_row and len(generator) != b:
            raise ValueError(f"generate: {len(generator)} generators for {b} rows")
        if gumbel_table is not None:
            gumbel_table = torch.as_tensor(gumbel_table, dtype=torch.float32, device=dev)
        tok = torch.full((b,), bos_token, dtype=torch.long, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        toks = [tok]
        for i in range(max_length - 1):
            h = t.wte(tok)[:, None] + t.wpe.weight[i + 1] + emb_off[:, None]
            for li, blk in enumerate(t.h):
                h = blk.decode_step(h, cache[0, li], cache[1, li], i)
            logits = self._logits(h)[:, 0].float() / temperature
            logits = top_k_top_p_filter(logits, top_k, top_p)
            g = (gumbel_table[i] if gumbel_table is not None
                 else _gumbel(generator, per_row, logits.shape, dev))
            nxt = torch.argmax(logits + g, dim=-1)
            if i >= max_length - 2:
                nxt = torch.full_like(nxt, eos_token)
            nxt = torch.where(done, eos_token, nxt)
            done = done | (nxt == eos_token)
            tok = nxt
            toks.append(tok)
        return torch.stack(toks, dim=1)


def _gumbel(generator, per_row: bool, shape, device):
    """Standard Gumbel draws -log(-log u), u uniform in [tiny, 1), f32."""
    if per_row:
        u = torch.stack([torch.rand(shape[1:], generator=g, device=device) for g in generator])
    else:
        u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def top_k_top_p_filter(logits, top_k: int = 0, top_p: float = 0.0,
                       filter_value: float = -1e10):
    """Top-k, then nucleus filtering of [B, V] logits: filtered entries take
    ``filter_value``; the nucleus keeps the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (the first token always).
    top_p 1.0 (the serving default) and 0 keep everything."""
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, filter_value, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] <= top_p],
                         dim=-1)
        kth = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, filter_value, logits)
    return logits


class OptimusVAE(nn.Module):
    """The two towers (``encoder``, ``decoder``) and their tokenizers."""

    def __init__(self, encoder: OptimusBertConnector, decoder: OptimusGPT2Connector,
                 tokenizer_encoder=None, tokenizer_decoder=None, latent_size: int = 768,
                 bos_id: int = GPT2_BOS, eos_id: int = GPT2_EOS):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.tokenizer_encoder = tokenizer_encoder   # BERT wordpiece (callable)
        self.tokenizer_decoder = tokenizer_decoder   # GPT-2 BPE (decode)
        self.latent_size, self.bos_id, self.eos_id = latent_size, bos_id, eos_id

    def encode_ids(self, input_ids):
        """Token ids [B, N] -> the posterior mean [B, latent]."""
        dev = self.encoder.linear.weight.device
        ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.long)
        return self.encoder(ids).chunk(2, dim=-1)[0]

    def encode(self, texts: Sequence[str], max_length: int = 77):
        if self.tokenizer_encoder is None:
            raise RuntimeError("no BERT tokenizer configured (its vocabulary file is "
                               "user-supplied)")
        return self.encode_ids(self.tokenizer_encoder([t.lower() for t in texts],
                                                      max_length=max_length))

    def decode_ids(self, z, generator=None, temperature: float = 1.0, gumbel_table=None):
        return self.decoder.generate(z, generator, temperature=temperature,
                                     eos_token=self.eos_id, bos_token=self.bos_id,
                                     gumbel_table=gumbel_table)

    def decode(self, z, generator=None, temperature: float = 1.0,
               gumbel_table=None) -> list[str]:
        """Texts of the latents z [B, latent]: BOS skipped, cut at the first
        EOS; without a GPT-2 tokenizer, the ids joined by spaces."""
        outs = []
        for row in self.decode_ids(z, generator, temperature, gumbel_table).tolist():
            ids = []
            for t in row[1:]:
                if t == self.eos_id:
                    break
                ids.append(t)
            outs.append(" ".join(map(str, ids)) if self.tokenizer_decoder is None
                        else self.tokenizer_decoder.decode(ids))
        return outs


def _optional(cfg):
    """A tokenizer from its config, or None where its vocabulary file is
    absent (vocabularies are user-supplied)."""
    from vdtpu_torch.config.registry import build
    if cfg is None:
        return None
    try:
        return build(cfg)
    except FileNotFoundError:
        return None


def build_optimus(encoder, decoder, tokenizer_encoder=None, tokenizer_decoder=None,
                  args=None) -> OptimusVAE:
    """``optimus_vae_next``: BOS/EOS are Optimus' 50258/50259 when the
    decoder's vocabulary holds them, else its last two ids."""
    from vdtpu_torch.config.registry import build
    vocab = decoder["args"]["config"]["vocab_size"]
    bos, eos = (GPT2_BOS, GPT2_EOS) if vocab > GPT2_EOS else (vocab - 2, vocab - 1)
    return OptimusVAE(build(encoder), build(decoder), _optional(tokenizer_encoder),
                      _optional(tokenizer_decoder),
                      latent_size=(args or {}).get("latent_size", 768), bos_id=bos, eos_id=eos)


def build_bert_tokenizer(vocab_file: str, do_lower_case: bool = False, **_unused):
    from vdtpu_torch.data.tokenizers import BertWordPieceTokenizer
    return BertWordPieceTokenizer(vocab_file, do_lower_case=do_lower_case)


def build_gpt2_tokenizer(vocab_file: str, merges_file: str, **_unused):
    from vdtpu_torch.data.tokenizers import GPT2BPETokenizer
    return GPT2BPETokenizer(vocab_file, merges_file)

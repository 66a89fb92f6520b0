"""Micro-batching request queue (``vdtpu/serving/queue.py``): concurrent
requests of all seven flows coalesce into padded CFG batches.

- Requests arriving within ``max_wait_ms`` of each other (up to the largest
  bucket) are gathered in one sweep.
- ``deadline_ms`` (optional) bounds coalescing latency: once the OLDEST
  queued request has waited that long since ``submit``, the worker stops
  waiting for more arrivals and dispatches what is queued.
- Each group's batch is padded up to a fixed bucket (1, 2, 4, 8 by
  default), so a request's arithmetic is fixed by its bucket.
- Each request's noise comes from its own seed (``request_noise``): a
  ``torch.Generator`` on the system's device, seeded with the request's
  seed, draws the request's x_T (or its q-sample noise) row first, as the
  flows' own generator draws it, and the same generator goes on into that
  row's text decode. With eta 0 every batch row is computed on its own
  (conv, GroupNorm, attention and the int8 sites' static scales are per
  sample; ToMe's merge is a product of fixed shape), so at a FIXED bucket a
  request's result does not depend on which co-riders or padding share its
  batch, and at bucket 1 it is ``inference_*`` of the same seed at n = 1,
  bit for bit. Across DIFFERENT buckets the kernels and libraries take
  other batch shapes: f32 agrees to rounding, int8 is quality-equivalent.

Flows that cannot share a diffuser batch form groups of their own
(``_Request.group``): t2i; t2t and i2t (text latents, then ONE batched
GPT-2 decode with one generator per row); i2i by its forward-step count
(fid_lvl quantizes to the DDIM steps, and each count is its own loop);
dcg / tcg / mcg by (image-context count, has-text, textstrength), which fix
the conditioning's shape and the batch's guidance scale and ratios.

Input images and masks are regularized to ``output_dim`` on the system's
device at enqueue time (``VDInference._regularize``), so every row of a
group shares H, W and batched and solo requests resize the same way.

All model work runs on the one worker thread, under ``torch.no_grad()``
(grad mode is per thread); ``submit_*`` are thread-safe and return a
``concurrent.futures.Future``: one [H, W, 3] image tensor on the system's
device, or one string for the text flows. A failure in a group is set on
every future of that group and on no other.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import torch

from vdtpu_torch.serving.postprocess import color_adjust_simple


def request_noise(seed: int, row, dtype, device):
    """(a request's first draw [1, *row], the generator that drew it): the
    generator seeded with ``seed`` on ``device``, as the flows seed theirs.
    The one place the queue draws noise."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((1, *row), generator=gen, device=device, dtype=dtype), gen


@dataclass
class _Request:
    text: str                 # prompt (t2i / t2t / mcg); unused for i2t / i2i
    seed: int
    flow: str = "t2i"         # "t2i" | "t2t" | "i2t" | "i2i" | "mcg"
    image: torch.Tensor | None = None  # [1, H, W, 3] regularized (i2t / i2i)
    fid_lvl: float = 0.0      # i2i
    fcs_lvl: float = 0.5      # i2i
    clr_adj: str | None = None  # i2i
    image_ctxs: tuple | None = None  # mcg family (dcg: 1 image, tcg: <= 2)
    textstrength: float = 0.0  # mcg family
    future: Future = field(default_factory=Future)
    t_enq: float = field(default_factory=time.monotonic)

    def group(self, ddim_steps: int) -> tuple:
        """Batchability key: rows of one diffuser batch share the latent
        shape, the loop length (i2i), the conditioning shape (mcg image
        count) and the batch's guidance scale and ratios (mcg textstrength)."""
        if self.flow == "i2i":
            k = int(ddim_steps * (1 - self.fid_lvl)) if self.fid_lvl else None
            return ("i2i", k)
        if self.flow == "mcg":
            has_text = bool(self.text) and self.textstrength != 0
            return ("mcg", len(self.image_ctxs), has_text,
                    round(float(self.textstrength), 6) if has_text else 0.0)
        return (self.flow,)


class BatchingQueue:
    """Batches concurrent requests of the seven flows through shared
    ``VDInference`` sampler calls, one padded bucket per group."""

    def __init__(self, inference, buckets=(1, 2, 4, 8), max_wait_ms: float = 20.0,
                 deadline_ms: float | None = None):
        if float(inference.ddim_eta) != 0.0:
            raise ValueError("BatchingQueue requires eta=0 (deterministic DDIM): "
                             "eta>0 draws batch-shaped noise, which would make "
                             "results depend on batch composition")
        self.inf = inference
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.deadline_s = None if deadline_ms is None else float(deadline_ms) / 1e3
        self._q: _queue.Queue[_Request | None] = _queue.Queue()
        self._uncond1 = None      # [1, 77, ctx] encoding of "", computed once
        self._uncond_img1 = None  # [1, 257, ctx] zeros-image encoding (i2t)
        self._closed = False
        # the closed check and the put happen under one lock, so no submit
        # can enqueue behind close()'s sentinel
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- client side ----

    def submit(self, text: str, seed: int) -> Future:
        """Text-to-image; the future resolves to one [H, W, 3] image."""
        return self._submit(_Request(text, int(seed)))

    def submit_t2t(self, text: str, seed: int) -> Future:
        """Text variation; the future resolves to one string."""
        return self._submit(_Request(text, int(seed), flow="t2t"))

    def submit_i2t(self, image, seed: int) -> Future:
        """Image-to-text; ``image`` is [1, H, W, 3] in [0, 1], any H, W; the
        future resolves to one string."""
        return self._submit(_Request("", int(seed), flow="i2t",
                                     image=self.inf._regularize(image)))

    def submit_i2i(self, image, fid_lvl: float, fcs_lvl: float, clr_adj: str | None,
                   seed: int) -> Future:
        """Image variation (``inference_i2i``'s arguments, any input H, W); the
        future resolves to one [H, W, 3] image at output_dim. fid_lvl 1
        resolves at once to the regularized input."""
        img = self.inf._regularize(image)
        if float(fid_lvl) == 1.0:
            f = Future()
            f.set_result(img[0])
            return f
        return self._submit(_Request("", int(seed), flow="i2i", image=img,
                                     fid_lvl=float(fid_lvl), fcs_lvl=float(fcs_lvl),
                                     clr_adj=clr_adj))

    def submit_dcg(self, image, fcs_lvl: float, text: str, textstrength: float,
                   seed: int) -> Future:
        """Dual-context blend (``inference_dcg``'s arguments)."""
        return self.submit_mcg([{"image": image, "strength": 1.0, "fcs_lvl": fcs_lvl}],
                               text=text, textstrength=textstrength, seed=seed)

    def submit_tcg(self, image_ctxs, text, textstrength, seed: int) -> Future:
        """Triple-context blend: ``submit_mcg`` on the first two contexts."""
        return self.submit_mcg(list(image_ctxs)[:2], text, textstrength, seed)

    def submit_mcg(self, image_ctxs, text: str | None, textstrength: float,
                   seed: int) -> Future:
        """Multi-context blend (``inference_mcg``'s arguments); the future
        resolves to one [H, W, 3] image (the inputs shown are not echoed)."""
        ctxs = tuple(dict(c) for c in image_ctxs
                     if c is not None and c.get("image") is not None)
        if not ctxs:
            raise ValueError("mcg needs at least one image context")
        for c in ctxs:
            c["image"] = self.inf._regularize(c["image"])
            if c.get("mask") is not None:
                c["mask"] = self.inf._regularize(c["mask"], "bilinear")
        return self._submit(_Request(text or "", int(seed), flow="mcg", image_ctxs=ctxs,
                                     textstrength=float(textstrength)))

    def _submit(self, r: _Request) -> Future:
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._q.put(r)
        return r.future

    def close(self):
        """Drain the queued requests, then stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker side ----

    def _gather(self) -> list[_Request] | None:
        """Block for the first request, then coalesce arrivals up to the
        largest bucket, until max_wait_ms passes with an empty queue or,
        with deadline_ms set, the oldest request's coalescing budget
        (counted from its submit) is spent."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = None if self.deadline_s is None else first.t_enq + self.deadline_s
        while len(batch) < self.buckets[-1]:
            timeout = self.max_wait_s
            if deadline is not None:
                remaining = deadline - time.monotonic()
                # budget spent: sweep what is already queued, wait for nothing
                timeout = None if remaining <= 0 else min(timeout, remaining)
            try:
                r = self._q.get_nowait() if timeout is None else self._q.get(timeout=timeout)
            except _queue.Empty:
                break
            if r is None:  # close(): process what we have, then stop
                self._q.put(None)
                break
            batch.append(r)
        return batch

    def _run(self):
        procs = {"t2i": self._process_t2i, "t2t": self._process_text,
                 "i2t": self._process_text, "i2i": self._process_i2i,
                 "mcg": self._process_mcg}
        while True:
            batch = self._gather()
            if batch is None:
                return
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                groups.setdefault(r.group(self.inf.ddim_steps), []).append(r)
            for gkey in sorted(groups, key=str):
                group = groups[gkey]
                try:
                    with torch.no_grad():
                        procs[group[0].flow](group)
                except Exception as e:  # noqa: BLE001 -- fail the whole group
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _noise(self, batch: list[_Request], b: int, row):
        """[b, *row] rows from each request's seed (zeros for padding), and
        each request's generator after its draw."""
        sys = self.inf.sys
        draws = [request_noise(r.seed, row, sys.dtype, sys.device) for r in batch]
        pad = torch.zeros((b - len(batch), *row), dtype=sys.dtype, device=sys.device)
        rows = [torch.as_tensor(x).to(device=sys.device, dtype=sys.dtype) for x, _ in draws]
        return torch.cat(rows + [pad]), [g for _, g in draws]

    def _text_uncond(self, b: int):
        if self._uncond1 is None:
            self._uncond1 = self.inf._encode_text([""])
        return self._uncond1.repeat(b, 1, 1)

    def _process_t2i(self, batch: list[_Request]):
        inf, n = self.inf, len(batch)
        b = self._bucket(n)
        # padding rows replicate request 0's prompt; their outputs are dropped
        c = inf._encode_text([r.text for r in batch] + [batch[0].text] * (b - n))
        shape = inf._image_shape(b)
        xt, _ = self._noise(batch, b, shape[1:])
        x = inf._sample(None, shape, {"type": "image", "xt": xt},
                        {"type": "text", "conditioning": c,
                         "unconditional_conditioning": self._text_uncond(b),
                         "unconditional_guidance_scale": inf.scale_textto})
        imgs = inf.sys.vae_decode(x, "image")
        for i, r in enumerate(batch):
            r.future.set_result(imgs[i])

    def _process_text(self, batch: list[_Request]):
        """One sampler pass over the text-latent rows of a t2t or i2t group,
        then one batched GPT-2 decode, each row on its request's generator."""
        inf, n = self.inf, len(batch)
        b = self._bucket(n)
        flow = batch[0].flow
        if flow == "t2t":
            c = inf._encode_text([r.text for r in batch] + [batch[0].text] * (b - n))
            u, scale = self._text_uncond(b), inf.scale_textto
        else:
            imgs = torch.cat([r.image for r in batch] + [batch[0].image] * (b - n))
            c = inf.sys.ctx_encode(imgs, "image")
            if self._uncond_img1 is None:  # zeros-image rows encode alike: once
                self._uncond_img1 = inf.sys.ctx_encode(torch.zeros_like(batch[0].image),
                                                       "image")
            u, scale = self._uncond_img1.repeat(b, 1, 1), inf.scale_imgto
        xt, gens = self._noise(batch, b, (inf.text_latent_dim,))
        x = inf._sample(None, (b, inf.text_latent_dim), {"type": "text", "xt": xt},
                        {"type": "text" if flow == "t2t" else "image", "conditioning": c,
                         "unconditional_conditioning": u,
                         "unconditional_guidance_scale": scale})
        # padding rows decode on a generator of their own; their text is dropped
        gens += [torch.Generator(device=inf.sys.device).manual_seed(0) for _ in range(b - n)]
        texts = inf._decode_texts(x, gens)
        for i, r in enumerate(batch):
            r.future.set_result(texts[i])

    def _process_i2i(self, batch: list[_Request]):
        """Image variation: the group shares its forward-step count (the
        group key); each row's context and x0 come from its own image, its
        x_T or q-sample noise from its own seed."""
        inf, n = self.inf, len(batch)
        b = self._bucket(n)
        fwd = batch[0].group(inf.ddim_steps)[1]
        cis = [inf._focus_filter(inf.sys.ctx_encode(r.image, "image"), r.fcs_lvl)
               for r in batch]
        c = torch.cat(cis + [cis[0]] * (b - n))
        shape = inf._image_shape(b)
        draw, _ = self._noise(batch, b, shape[1:])
        x_info = {"type": "image", "xt": draw}
        if fwd is not None:
            x0s = [inf.sys.vae_encode(r.image, "image") for r in batch]
            x_info = {"type": "image", "x0": torch.cat(x0s + [x0s[0]] * (b - n)),
                      "x0_forward_timesteps": fwd, "noise": draw}
        x = inf._sample(None, shape, x_info,
                        {"type": "image", "conditioning": c,
                         "unconditional_conditioning": torch.zeros_like(c),
                         "unconditional_guidance_scale": inf.scale_imgto})
        imgs = inf.sys.vae_decode(x, "image")
        for i, r in enumerate(batch):
            out = imgs[i:i + 1]
            if r.clr_adj == "Simple":
                out = color_adjust_simple(out, r.image)
            r.future.set_result(out[0])

    def _process_mcg(self, batch: list[_Request]):
        """Multi-context blends (dcg, tcg, mcg): the group shares (image
        count, has-text, textstrength); each row's conditioning comes from
        ``_mcg_context`` at n = 1, and the rows are stacked."""
        inf, n = self.inf, len(batch)
        b = self._bucket(n)
        row_infos = [inf._mcg_context(list(r.image_ctxs), r.text, r.textstrength, n=1)[1]
                     for r in batch]
        c_info_list = []
        for e in range(len(row_infos[0])):
            rows = [ri[e]["conditioning"] for ri in row_infos]
            urows = [ri[e]["unconditional_conditioning"] for ri in row_infos]
            c_info_list.append(dict(row_infos[0][e],
                                    conditioning=torch.cat(rows + [rows[0]] * (b - n)),
                                    unconditional_conditioning=torch.cat(
                                        urows + [urows[0]] * (b - n))))
        shape = inf._image_shape(b)
        xt, _ = self._noise(batch, b, shape[1:])
        x = inf._sample_multi(None, shape, {"type": "image", "xt": xt}, c_info_list)
        imgs = inf.sys.vae_decode(x, "image")
        for i, r in enumerate(batch):
            r.future.set_result(imgs[i])

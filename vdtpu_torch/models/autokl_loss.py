"""VAE adversarial training loss (``vdtpu/models/autokl_loss.py``): LPIPS
over VGG16 features, a PatchGAN discriminator, and the two-branch
``LPIPSWithDiscriminator`` with its adaptive weight. NCHW.

State-dict keys are the JAX package's flax names (``lpips.net.features.0``,
``lpips.lin0.model.1``, ``discriminator.main.3``, ``logvar``), which are the
published LPIPS and torchvision layouts, so ``interop.from_jax.
loss_state_dict_from_jax`` converts a vdtpu loss tree and an LPIPS file
loads as it is.

The discriminator's BatchNorm runs on batch statistics in every pass, as
vdtpu's does (``mutable=["batch_stats"]``): ``generator_loss`` leaves the
running statistics as they are, ``discriminator_loss`` updates them from the
real batch alone (flax's rule: biased variance, ``running = 0.9 running +
0.1 batch``). The adaptive weight differentiates the reconstruction graph
with respect to the decoder's last kernel (``torch.autograd.grad``), where
vdtpu re-runs the decoder under ``jax.grad``; the values are the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

# torchvision vgg16.features indices of the conv layers per LPIPS slice
_VGG_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_VGG_CHANNELS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


class VGG16Features(nn.Module):
    """VGG16 feature slices relu1_2 .. relu5_3; the convs are
    ``features.{i}`` at torchvision's indices, a 2x2 max pool opens slices
    1-4."""

    def __init__(self):
        super().__init__()
        self.features = nn.Module()
        cin = 3
        for idxs, chans in zip(_VGG_SLICES, _VGG_CHANNELS):
            for i, ch in zip(idxs, chans):
                self.features.add_module(str(i), nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x) -> list[torch.Tensor]:
        outs = []
        for s, idxs in enumerate(_VGG_SLICES):
            if s > 0:
                x = F.max_pool2d(x, 2, 2)
            for i in idxs:
                x = F.relu(getattr(self.features, str(i))(x))
            outs.append(x)
        return outs


class _NetLin(nn.Module):
    """LPIPS' 1x1 bias-free head, at ``model.1`` as in the LPIPS layout."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """Learned perceptual distance of two [B, 3, H, W] images in [-1, 1]:
    [B, 1, 1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, chans in enumerate(_VGG_CHANNELS):
            self.add_module(f"lin{k}", _NetLin(chans[-1]))
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, y):
        dt = self.shift.dtype
        fx = self.net((x.to(dt) - self.shift) / self.scale)
        fy = self.net((y.to(dt) - self.shift) / self.scale)
        norm = lambda t: t / (torch.sqrt(torch.sum(t ** 2, dim=1, keepdim=True)) + 1e-10)
        val = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            d = getattr(self, f"lin{k}")((norm(a) - norm(b)) ** 2)
            val = val + d.mean(dim=(2, 3), keepdim=True)
        return val


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) in f32: batch
    statistics when training (mean, and E[x^2] - E[x]^2 clipped at 0),
    the running ones otherwise. Training records the batch statistics
    (``last_stats``); ``update`` folds them into the running ones."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.last_stats = None

    def forward(self, x, train: bool = True):
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self.last_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        col = lambda t: t.float()[:, None, None]
        y = (xf - col(mean)) * torch.rsqrt(col(var) + self.eps)
        return (y * col(self.weight) + col(self.bias)).to(x.dtype)

    @torch.no_grad()
    def update(self):
        mean, var = self.last_stats
        m = self.momentum
        self.running_mean.mul_(m).add_((1.0 - m) * mean)
        self.running_var.mul_(m).add_((1.0 - m) * var)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator, ``main.{idx}`` at the reference's Sequential
    indices: 4x4 convs (padding 1), leaky ReLU 0.2, BatchNorm between."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        conv = lambda cin, cout, stride, bias=True: nn.Conv2d(cin, cout, 4, stride, 1,
                                                               bias=bias)
        layers: list[nn.Module] = [conv(input_nc, ndf, 2), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(2 ** n, 8)
            layers += [conv(ndf * nf_prev, ndf * nf, 2, bias=False), BatchNorm(ndf * nf),
                       nn.LeakyReLU(0.2)]
        nf_prev, nf = nf, min(2 ** n_layers, 8)
        layers += [conv(ndf * nf_prev, ndf * nf, 1, bias=False), BatchNorm(ndf * nf),
                   nn.LeakyReLU(0.2), conv(ndf * nf, 1, 1)]
        self.main = nn.Sequential(*layers)

    def forward(self, x, train: bool = True):
        for layer in self.main:
            x = layer(x, train) if isinstance(layer, BatchNorm) else layer(x)
        return x

    def update_stats(self) -> dict[str, torch.Tensor]:
        """Fold the last training pass's batch statistics into the running
        ones; returns the new running statistics by state-dict key."""
        out = {}
        for i, bn in enumerate(self.main):
            if isinstance(bn, BatchNorm):
                bn.update()
                out[f"main.{i}.running_mean"] = bn.running_mean.clone()
                out[f"main.{i}.running_var"] = bn.running_var.clone()
        return out


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


class LPIPSWithDiscriminator(nn.Module):
    """The two optimizer branches of VAE GAN training: ``generator_loss``
    (reconstruction NLL with a learned ``logvar``, KL, the adversarial term)
    and ``discriminator_loss``."""

    def __init__(self, disc_start: int, logvar_init: float = 0.0, kl_weight: float = 1.0,
                 pixelloss_weight: float = 1.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge"):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss must be hinge or vanilla: {disc_loss!r}")
        self.disc_start = disc_start
        self.kl_weight = kl_weight
        self.pixel_weight = pixelloss_weight
        self.perceptual_weight = perceptual_weight
        self.disc_factor = disc_factor
        self.discriminator_weight = disc_weight
        self.disc_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.lpips = LPIPS()
        self.discriminator = NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers)
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)))

    def nll_and_rec(self, inputs, reconstructions):
        """(sum of the NLL, sum of the reconstruction loss), each over the batch size."""
        rec = torch.abs(inputs - reconstructions)
        if self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * self.lpips(inputs, reconstructions)
        nll = rec / torch.exp(self.logvar) + self.logvar
        bsz = inputs.shape[0]
        return torch.sum(nll) / bsz, torch.sum(rec) / bsz

    def calculate_adaptive_weight(self, nll_loss, g_loss, last_layer):
        """||d nll / d last_layer|| / (||d g_loss / d last_layer|| + 1e-4),
        clipped to [0, 1e4], times ``disc_weight``, detached; both losses
        come from one reconstruction graph, which stays for the backward."""
        nll_g = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)[0]
        adv_g = torch.autograd.grad(g_loss, last_layer, retain_graph=True)[0]
        d_weight = torch.norm(nll_g) / (torch.norm(adv_g) + 1e-4)
        return torch.clamp(d_weight, 0.0, 1e4).detach() * self.discriminator_weight

    def generator_loss(self, inputs, reconstructions, posterior, global_step: int,
                       d_weight=None, last_layer=None):
        """The generator branch: (loss, log). ``last_layer`` (the decoder's
        last kernel, in the graph of ``reconstructions``) makes the
        adversarial weight adaptive; else ``d_weight``, else the static
        weight. The discriminator's running statistics stay as they are."""
        nll_loss, rec_loss = self.nll_and_rec(inputs, reconstructions)
        kl_loss = torch.sum(posterior.kl()) / inputs.shape[0]
        logits_fake = self.discriminator(reconstructions)
        g_loss = -torch.mean(logits_fake)
        if last_layer is not None:
            d_weight = self.calculate_adaptive_weight(nll_loss, g_loss, last_layer)
        elif d_weight is None:
            d_weight = torch.tensor(0.0 if self.disc_factor == 0 else self.discriminator_weight,
                                    device=inputs.device)
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        loss = nll_loss + self.kl_weight * kl_loss + d_weight * disc_factor * g_loss
        return loss, {"Loss": loss, "loss_kl": kl_loss, "loss_nll": nll_loss,
                      "loss_rec": rec_loss, "d_weight": d_weight, "loss_g": g_loss,
                      "logvar": self.logvar.detach()}

    def discriminator_loss(self, inputs, reconstructions, global_step: int):
        """The discriminator branch on detached inputs: (loss, log, the
        running statistics after the update from the real batch)."""
        logits_real = self.discriminator(inputs.detach())
        stats = self.discriminator.update_stats()
        logits_fake = self.discriminator(reconstructions.detach())
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        d_loss = disc_factor * self.disc_loss(logits_real, logits_fake)
        return d_loss, {"Loss": d_loss, "loss_disc": d_loss,
                        "logits_real": torch.mean(logits_real),
                        "logits_fake": torch.mean(logits_fake)}, stats

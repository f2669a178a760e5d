"""Plain generation: classifier-free guidance as one 2x batch, the solver,
the f32 VAE decode and the analog-bit decode of the panoptic mask.

Guidance is cond + scale * (cond - uncond) on the noise and on the mask
prediction alike; the unconditional half takes the empty CLIP context, or
the null class of a class-conditional model.  Images come out in [0, 1]
channel-last; a mask's 8 analog bits (most significant first) become an
integer id where each bit is > 0.
"""
from __future__ import annotations

import torch

from . import solver, uvit, vae


def guided(net, scale, uncond):
    """The guided model of the solver; `uncond` is the empty context
    (77, D) or the null label (an int)."""

    def model(x, t, mask=None):
        b = x.shape[0]
        x2, t2 = torch.cat([x, x]), torch.cat([t, t])
        if mask is None:
            y2 = torch.cat([net.cond, torch.full_like(net.cond, uncond)])
            c, u = net(x2, t2, y2).chunk(2)
            return c + scale * (c - u)
        ctx2 = torch.cat([net.cond, uncond.expand(b, *uncond.shape)])
        noise, pm = net(x2, t2, ctx2, torch.cat([mask, mask]))
        nc, nu = noise.chunk(2)
        mc, mu = pm.chunk(2)
        return nc + scale * (nc - nu), mc + scale * (mc - mu)

    return model


class Net:
    """The network of one family over its weights, with the request's
    conditioning (`cond`) attached for the guided model."""

    def __init__(self, family, weights, sizes, cond, quant=uvit.identity):
        self.family, self.w, self.sizes, self.cond, self.quant = family, weights, sizes, cond, quant

    def __call__(self, *args):
        fn = uvit.uvit_t2i if self.family == "uvit_t2i" else uvit.uvit
        return fn(self.w, self.sizes, *args, quant=self.quant)


def bits_to_ids(mask, bits):
    """(B, bits, S, S) analog bits -> (B, S, S, 1) int ids, MSB first."""
    on = (mask > 0).to(torch.int64)
    weights = 2 ** torch.arange(bits - 1, -1, -1, device=mask.device)
    return (on * weights[None, :, None, None]).sum(1)[..., None]


def generate(family, net_weights, vae_weights, sizes, cond, z, m0, scale, uncond,
             scale_factor, steps, geometry=vae.SD_F8, quant=uvit.identity):
    """One request's images (B, H, W, 3) in [0, 1] and, with a mask, its ids."""
    net = Net(family, net_weights, sizes, cond, quant)
    ns = solver.DiscreteVP(solver.sd_betas())
    out = solver.sample(guided(net, scale, uncond), ns, z, m0, steps=steps)
    latents, pm = out if m0 is not None else (out, None)
    images = vae.decode(vae_weights, latents, scale_factor, geometry)
    images01 = ((images + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1)
    return images01, None if pm is None else bits_to_ids(pm, sizes["mask_bits"])

"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM, the
least time of a kernel call (its roofline bound), the operations and bytes
of the attention kernels, and the operations of the KL-VAE decoder.

Operations are counted from shapes, as the algorithm needs them (a
multiply-add is 2), never from what an implementation launches; bytes count
each input read once and each output written once.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate, H100 SXM data sheet
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet


def bound_s(nbytes, flops):
    """max(bytes / peak bandwidth, operations / peak bf16 rate), seconds."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)


def attention_fwd(b, l, h, d, with_lse=False):
    """(bytes, operations) of softmax(q k^T) v from packed bf16 (B, L, 3C)
    qkv to (B, L, C), with each row's f32 log-sum-exp (B, H, L) when asked."""
    c = h * d
    nbytes = (b * l * 3 * c + b * l * c) * 2 + (4 * b * h * l if with_lse else 0)
    return nbytes, 4 * b * l * l * c


def attention_bwd(b, l, h, d):
    """(bytes, operations) of the attention's gradient from qkv and the
    output's cotangent to dqkv (bf16), rebuilding the probabilities from
    the scores: q k^T, dV, dP, dQ, dK."""
    c = h * d
    return 14 * b * l * c, 10 * b * l * l * c


def linear(tokens, n_in, n_out):
    return 2 * tokens * n_in * n_out


def conv(h, w, c_in, c_out, k):
    """A k x k convolution producing (h, w, c_out)."""
    return 2 * h * w * c_out * c_in * k * k


def vae_decoder(geometry, h, w, z_channels=4, out_ch=3):
    """Operations of one KL-VAE decode of an (h, w) latent: post_quant_conv,
    conv_in, the middle (two ResNet blocks, one attention), the levels with
    their upsampling convolutions, conv_out."""
    ch, mult, nrb = geometry["ch"], geometry["ch_mult"], geometry["num_res_blocks"]

    def resnet(hh, ww, c_in, c_out):
        f = conv(hh, ww, c_in, c_out, 3) + conv(hh, ww, c_out, c_out, 3)
        return f + (conv(hh, ww, c_in, c_out, 1) if c_in != c_out else 0)

    c = ch * mult[-1]
    flops = conv(h, w, z_channels, z_channels, 1) + conv(h, w, z_channels, c, 3)
    flops += 2 * resnet(h, w, c, c)
    n = h * w
    flops += 4 * conv(h, w, c, c, 1) + 4 * n * n * c
    for level in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            flops += resnet(h, w, c, ch * mult[level])
            c = ch * mult[level]
        if level:
            h, w = 2 * h, 2 * w
            flops += conv(h, w, c, c, 3)
    return flops + conv(h, w, c, out_ch, 3)

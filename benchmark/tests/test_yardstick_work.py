"""The operation and byte counts against hand-worked values at each cell's
shapes."""
import pytest

from benchmark import harness, work
from benchmark.families import uvit, uvit_t2i


def sizes(config):
    return harness.load_json("configs", config)["config"]["nnet"]


def test_attention_kernel_counts_at_the_cells_shapes():
    # (B, L, H, D) = (64, 334, 8, 64): qkv (64 x 334 x 1536) + out (64 x 334 x 512), bf16
    assert work.attention_fwd(64, 334, 8, 64) == (64 * 334 * 2048 * 2, 4 * 64 * 334 ** 2 * 512)
    assert work.attention_fwd(64, 334, 8, 64, True)[0] == 87_556_096 + 4 * 64 * 8 * 334
    assert work.attention_bwd(64, 590, 8, 64) == (270_663_680, 114_065_408_000)
    # the bounds phase 3 printed: 26.1 / 46.2 us at B = 64, L = 334 / 590; 40.4 at (64, 258, 16)
    assert work.bound_s(*work.attention_fwd(64, 334, 8, 64)) * 1e6 == pytest.approx(26.136, 1e-4)
    assert work.bound_s(*work.attention_fwd(64, 590, 8, 64)) * 1e6 == pytest.approx(46.169, 1e-4)
    assert work.bound_s(*work.attention_fwd(64, 258, 16, 64)) * 1e6 == pytest.approx(40.378, 1e-4)


def test_uvit_large_forward_by_hand():
    t, c = 258, 1024
    blocks = 21 * 2 * t * c * (3 * c + c + 8 * c)
    skips = 10 * 2 * t * 2 * c * c
    attention = 21 * 4 * t * t * c
    embed_and_head = 2 * 256 * 16 * c * 2 + 2 * 32 * 32 * 4 * 4 * 9
    assert uvit.forward_flops(sizes("imagenet256_uvit_large"), 1) == \
        blocks + skips + attention + embed_and_head == 152_912_379_904
    assert uvit.train_flops(sizes("imagenet256_uvit_large"), 128) == \
        128 * (3 * (blocks + skips + attention + 2 * 256 * 16 * c + 2 * 32 * 32 * 144)
               + 2 * 2 * 256 * 16 * c)
    assert uvit.attention_calls(sizes("imagenet256_uvit_large"), 64) == [(64, 258, 16, 64, 21)]


def test_panoptic_forward_by_hand():
    c, lx, lm = 512, 334, 590
    block = 2 * c * (3 * c + c + 8 * c)
    image = 13 * block * lx + 6 * 2 * lx * 2 * c * c + 13 * 4 * lx * lx * c
    mask = 13 * block * lm + 6 * 2 * lm * 2 * c * c + 13 * 4 * lm * lm * c
    embeds = 2 * 256 * 16 * c + 2 * 77 * 768 * c + 2 * 256 * 128 * c
    heads = (13 * 2 * lx * c * c + 2 * 256 * c * 16 + 2 * 256 * c * 128
             + 2 * 32 * 32 * 4 * 4 * 9 + 2 * 64 * 64 * 8 * 8 * 9)
    assert uvit_t2i.forward_flops(sizes("mscoco_uvit_small"), 1) == image + mask + embeds + heads
    assert uvit_t2i.attention_calls(sizes("mscoco_uvit_small"), 64) == \
        [(64, 334, 8, 64, 13), (64, 590, 8, 64, 13)]
    # fine-tune: no weight gradient of the image stream, no input gradient of the embeddings
    s = sizes("mscoco_uvit_small")
    assert uvit_t2i.train_flops(s, 64, False) - uvit_t2i.train_flops(s, 64, True) == \
        64 * (13 * block * lx + 6 * 2 * lx * 2 * c * c + 2 * 256 * 16 * c + 2 * 77 * 768 * c)


def test_vae_decoder_by_hand():
    def conv(h, cin, cout, k):
        return 2 * h * h * cout * cin * k * k

    def res(h, cin, cout):
        return conv(h, cin, cout, 3) + conv(h, cout, cout, 3) + (
            conv(h, cin, cout, 1) if cin != cout else 0)

    total = (conv(32, 4, 4, 1) + conv(32, 4, 512, 3) + 2 * res(32, 512, 512)
             + 4 * conv(32, 512, 512, 1) + 4 * 1024 ** 2 * 512
             + 3 * res(32, 512, 512) + conv(64, 512, 512, 3)
             + 3 * res(64, 512, 512) + conv(128, 512, 512, 3)
             + res(128, 512, 256) + 2 * res(128, 256, 256) + conv(256, 256, 256, 3)
             + res(256, 256, 128) + 2 * res(256, 128, 128) + conv(256, 128, 3, 3))
    assert total == 622_187_282_432
    assert work.vae_decoder({"ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2},
                            32, 32) == total

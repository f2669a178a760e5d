"""The numbers the port's measurement scripts compute, against the same
quantities computed with the JAX package on shared weights
(`utils/weights.py` layouts through `utils/torch_bridge.py`), on the CPU.

- `bench_speed_modes`: the relative L2 and mean absolute deviation of the
  combo=0.2:0.0,0.5 mode (forecast-skip tau 0.2 and CFG on only for t in
  [0, 0.5]) from the exact protocol, at a tiny U-ViT (width 32, depth 2,
  f32, its weights redrawn N(0, 0.5^2) so that the label moves the
  prediction: the deviation is ~1e-2, where the seeded initialisation gives
  ~1e-4, too near what two f32 pipelines agree to; a f32 VAE of width 32)
  over 17 steps (the first count at
  which accel 0.2 skips), against the same deviations of the root
  `bench.py` protocol restated with JAX's `DPMSolver`, CFG and VAE on the
  same noise: rtol 1e-3.
- `bench_ring_hop`: `make_ring_local`'s rolled sp = 2 hop sequence over 3
  layers, both arms (the kernel arm is the plain hop on the CPU), against
  the root script's sequence restated with JAX's `_hop_xla` (the plain
  reference of its Pallas `attention_hop`) in f32: rtol 1e-4 / atol 1e-5.
- `bench_loader`: the feature directory `build_dir` writes against the JAX
  script's layout, restated: the names, dtypes and shapes of each sample's
  files, and the values of numpy's seed-0 draws in the JAX script's order.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_class_cond as jax_cfg
from panopticdiffusionmodels_tpu.diffusion.schedule import stable_diffusion_beta_schedule
from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.ops.ring_attention import _hop_xla
from panopticdiffusionmodels_tpu.samplers.dpm_solver import DPMSolver as JaxDPMSolver
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_autoencoder_kl, convert_uvit
from panopticdiffusionmodels_torch.models.vae import AutoencoderKL
from panopticdiffusionmodels_torch.scripts import bench, bench_loader, bench_ring_hop
from panopticdiffusionmodels_torch.scripts import bench_speed_modes as bsm

VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
STEPS = 17  # accel 0.2 skips from 17 steps on
MODE = "combo=0.2:0.0,0.5"  # forecast-skip and the guidance interval


def jax_images(params, vae_params, z, y, accel, interval):
    """The root `bench.py` pipeline restated at the tiny geometry with a
    f32 VAE: CFG 0.4 against the null class 1000 as one 2x batch, order-3
    DPM-Solver++ fast (eps 1/1000, T 1), then the decode."""
    model = JaxUViT(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=2, num_heads=2,
                    num_classes=1001, dtype=jnp.float32, scan_blocks=True, attn_impl="xla")
    vae = JaxAutoencoderKL(**VAE, dtype=jnp.float32)

    @jax.jit
    def pipeline(params, vae_params, z, y):
        cfg_fn = jax_cfg(lambda xx, tt, yy: model.apply(params, xx, tt, yy),
                         null_label=1000, scale=0.4, enabled=True)
        solver = JaxDPMSolver(
            lambda xx, tt, mask_token=None, cfg_on=True: cfg_fn(xx, tt * 1000, y,
                                                                 cfg_on=cfg_on),
            JaxNS("discrete", betas=stable_diffusion_beta_schedule()), predict_x0=True,
            accel_tau=accel, cfg_interval=interval)
        z0 = solver.sample(z, steps=STEPS, eps=1.0 / 1000, T=1.0, order=3, method="fast")
        return vae.apply(vae_params, z0, method="decode")

    return np.asarray(pipeline(params, vae_params, z, y), np.float64)


def test_speed_mode_deviation_matches_jax(monkeypatch):
    monkeypatch.setenv("BENCH_STEPS", str(STEPS))
    config, model, _ = bench.build_components("cpu", depth=2, embed_dim=32, num_heads=2,
                                              img_size=8, vae_geometry=VAE,
                                              dtype=torch.float32)
    torch.manual_seed(1)
    vae = AutoencoderKL(**VAE, dtype=torch.float32).eval()  # the decode in f32 on both sides
    comps = config, model, vae
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    batch = 2
    _, base, _, _ = bsm.run_mode(comps, batch, 0.0, None, False, reps=1)
    accel, interval, gelu = bsm.mode_knobs(MODE)
    _, img, evals, _ = bsm.run_mode(comps, batch, accel, interval, gelu, reps=1)
    assert evals < STEPS  # the mode skipped evaluations
    rel, mad = bsm.deviation(img, base)

    g = torch.Generator().manual_seed(bsm.NOISE_SEED)  # run_mode's noise on the CPU
    z = torch.randn((batch, 4, 8, 8), generator=g).permute(0, 2, 3, 1).numpy()
    params = convert_uvit({k: v.numpy() for k, v in model.state_dict().items()}, depth=2,
                          num_classes=1001, scan_blocks=True)
    vae_params = convert_autoencoder_kl(
        {k: v.float().numpy() for k, v in vae.state_dict().items()},
        ch_mult=VAE["ch_mult"], num_res_blocks=1)
    y = jnp.zeros((batch,), jnp.int32)
    jbase, jimg = (jax_images(params, vae_params, jnp.asarray(z), y, *knobs)
                   for knobs in ((0.0, None), (accel, interval)))
    np.testing.assert_allclose(base, jbase, rtol=1e-3, atol=1e-4)
    want_rel = float(np.linalg.norm(jimg - jbase) / np.linalg.norm(jbase))
    want_mad = float(np.abs(jimg - jbase).mean())
    assert want_rel > 1e-3  # a deviation to compare, not rounding
    np.testing.assert_allclose([rel, mad], [want_rel, want_mad], rtol=1e-3)


def jax_ring_local(heads, scale, sp, depth):
    """The root script's `make_ring_local` over `_hop_xla`, restated."""
    def attn(qkv):
        b, lq, c3 = qkv.shape
        c = c3 // 3
        d = c // heads
        q, kv = qkv[..., :c], qkv[..., c:]
        o_hop, m, den = _hop_xla(q, kv, heads, scale, jnp.int32(lq))
        o = o_hop.astype(jnp.float32).reshape(b, lq, heads, d)
        for hop in range(1, sp):
            kv = jnp.roll(kv, 7 * hop, axis=1)
            o_hop, m_hop, den_hop = _hop_xla(q, kv, heads, scale, jnp.int32(lq))
            m_new = jnp.maximum(m, m_hop)
            corr, corr_hop = jnp.exp(m - m_new), jnp.exp(m_hop - m_new)
            den = den * corr + den_hop * corr_hop
            o = o * corr + o_hop.astype(jnp.float32).reshape(b, lq, heads, d) * corr_hop
            m = m_new
        return (o / den).astype(qkv.dtype).reshape(b, lq, c)

    @jax.jit
    def fn(qkv):
        def body(x, _):
            o = attn(x)
            nxt = x + jnp.concatenate([o, o, o], axis=-1)
            rms = jnp.sqrt(jnp.mean(jnp.square(nxt.astype(jnp.float32)), axis=-1,
                                    keepdims=True) + 1e-6)
            return (nxt / rms).astype(x.dtype), ()

        return jax.lax.scan(body, qkv, None, length=depth)[0]

    return fn


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain_hop", "kernel_hop"])
def test_ring_hop_sequence_matches_jax(use_kernel):
    heads, d, depth = 2, 16, 3
    scale = d ** -0.5
    qkv = (np.random.default_rng(0).standard_normal((2, 12, 3 * heads * d)) * 0.5
           ).astype(np.float32)
    got = bench_ring_hop.make_ring_local(heads, scale, bench_ring_hop.SP, use_kernel, depth)(
        torch.from_numpy(qkv))
    want = jax_ring_local(heads, scale, bench_ring_hop.SP, depth)(jnp.asarray(qkv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_loader_directory_is_the_jax_layout(tmp_path):
    n = 2
    bench_loader.build_dir(str(tmp_path), n)
    names = {f"{i}.npy" for i in range(n)} | {f"{i}_seg.npy" for i in range(n)} | {
        f"{i}_{k}.npy" for i in range(n) for k in range(5)}
    assert set(os.listdir(tmp_path)) == names
    rng = np.random.default_rng(0)  # the JAX script's draws, in its order
    for i in range(n):
        layout = [(f"{i}.npy", rng.normal(size=(8, 32, 32)).astype(np.float32))]
        layout += [(f"{i}_{k}.npy", rng.normal(size=(77, 768)).astype(np.float32))
                   for k in range(5)]
        layout.append((f"{i}_seg.npy", rng.integers(0, 201, (256, 256)).astype(np.int64)))
        for name, want in layout:
            got = np.load(tmp_path / name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want)


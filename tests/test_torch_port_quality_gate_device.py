"""The quality gate's sampling pipelines and its training step against the JAX
package, on the CPU at a tiny geometry (latents 8x8x4, width 32, depth 4,
4 heads; the panoptic model's mask 16x16 and contexts 7 x 16; a VAE of
width 32), f32, on the same weights (the port's seeded gate models, zero
convs opened, carried to JAX by `convert_uvit` / `convert_uvit_t2i` /
`convert_autoencoder_kl`) and the same noise:

  * `quality_gate._build_trained` (class-conditional CFG 0.4 against the
    null label 10) and `_build_trained_panoptic` (t2i CFG 1.0 against the
    zero context, the mask extrapolated), each loading its parameters from
    QG_DIR, against JAX's `model.apply` + `DPMSolver` + CFG + the VAE decode
    restated from `scripts/quality_gate.py:_build_trained*`, 4 steps, for
    exactA, accel=0.2 and interval=0.0,0.5 (and ihold=0.5,1.0 on the
    panoptic geometry): z0, the mask prediction and the image at rtol 1e-4
    / atol 1e-5;
  * three `GateTrainer` steps of each model (AdamW with the 500-step
    linear warm-up, weight decay 0.03, EMA 0.999; the panoptic one with
    remat) against `optax.adamw(optax.linear_schedule(...))` + the EMA on
    the JAX draws of the same keys, both schedules started at update 250
    (half-way up the warm-up, fresh moments) so that every update is
    lr-sized: the losses, the parameters and the EMA after each step at
    rtol 1e-4 / atol 1e-5, and what the steps changed (parameters and EMA
    less their start) within 5e-3 of JAX's largest change plus 4 f32 ulps
    of the value (both sides round the stored value; Adam carries a
    near-cancelled gradient element's error at full size: 2.5e-3 on one
    element of the panoptic model).  The EMA moves by a
    thousandth of the parameters, under that atol, so only the second bar
    holds the EMA rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion import Schedule as JaxSchedule
from panopticdiffusionmodels_tpu.diffusion import l_simple_panoptic as jax_l_simple_panoptic
from panopticdiffusionmodels_tpu.diffusion import stable_diffusion_beta_schedule
from panopticdiffusionmodels_tpu.diffusion.analog_bits import ints_to_analog
from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_class_cond, make_cfg_t2i
from panopticdiffusionmodels_tpu.diffusion.schedule import MASK_NOISE_SCALE
from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.models import UViTT2I as JaxUViTT2I
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.samplers import DPMSolver, NoiseScheduleVP
from panopticdiffusionmodels_tpu.utils.torch_bridge import (
    convert_autoencoder_kl,
    convert_uvit,
    convert_uvit_t2i,
)
from panopticdiffusionmodels_torch.scripts import quality_gate as pqg

VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.2301)
TINY = pqg.Geometry(size=8, embed_dim=32, depth=4, num_heads=4, mask=16, clip_dim=16,
                    clip_tokens=7, vae=VAE, dtype=torch.float32)
BATCH, STEPS = 3, 4
TOL = dict(rtol=1e-4, atol=1e-5)
NET = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
           scan_blocks=True, dtype=jnp.float32)
PAN = dict(clip_dim=16, num_clip_token=7, mask_bits=8, mask_size=16, enable_panoptic=True,
           separate=True)


def _numpy(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _open_zero_convs(model):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("zero_convs"):
                p.normal_(0, 0.02)


def _jax_model(panoptic, attn_impl="auto", use_checkpoint=False):
    if panoptic:
        return JaxUViTT2I(**NET, **PAN, attn_impl=attn_impl, use_checkpoint=use_checkpoint)
    return JaxUViT(**NET, num_classes=11, attn_impl=attn_impl, use_checkpoint=use_checkpoint)


def _jax_params(panoptic, model):
    sd = _numpy(model.state_dict())
    tree = (convert_uvit_t2i(sd, depth=4, scan_blocks=True) if panoptic
            else convert_uvit(sd, depth=4, num_classes=11, scan_blocks=True))
    return tree


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """The seeded tiny gate models' parameters written where `_build_trained*`
    read them, and the JAX side's parameters and VAE."""
    tmp = tmp_path_factory.mktemp("qg")
    mp = pytest.MonkeyPatch()
    mp.setenv("QG_DIR", str(tmp))
    models = {}
    for geo, panoptic in (("trained", False), ("trained_panoptic", True)):
        torch.manual_seed(3)
        model = (pqg._trained_panoptic_model(False, geo_dims=TINY) if panoptic
                 else pqg._trained_model(False, geo_dims=TINY))
        _open_zero_convs(model)
        torch.save(model.state_dict(), pqg._params_path(geo))
        models[geo] = model
    vae = pqg._gate_vae(TINY, "cpu")
    jvae = JaxAutoencoderKL(**VAE)
    jvae_params = convert_autoencoder_kl(_numpy(vae.state_dict()), ch_mult=(1, 2),
                                         num_res_blocks=1)
    yield dict(models=models, vae=vae, jvae=jvae, jvae_params=jvae_params)
    mp.undo()


def _jax_pipeline(panoptic, params, jvae, jvae_params, accel, interval, hold):
    betas = stable_diffusion_beta_schedule()
    n_train = JaxSchedule(betas).N
    ns = NoiseScheduleVP("discrete", betas=betas)
    model = _jax_model(panoptic)

    @jax.jit
    def run(params, vae_params, cond, z, m):
        if panoptic:
            cfg_fn = make_cfg_t2i(lambda xx, tt, cc, mask_token=None: model.apply(
                params, xx, tt, cc, mask_token=mask_token), np.zeros((7, 16), np.float32),
                scale=1.0, enabled=True)
            solver = DPMSolver(
                lambda xx, tt, mask_token=None, cfg_on=True, **mkw: cfg_fn(
                    xx, tt * n_train, cond, mask_token=mask_token, cfg_on=cfg_on, **mkw),
                ns, predict_x0=True, accel_tau=accel, cfg_interval=interval,
                mask_guidance_hold=hold)
            z0, pm = solver.sample(z, steps=STEPS, eps=1.0 / 1000, T=1.0, order=3,
                                   method="fast", mask_token=m)
        else:
            cfg_fn = make_cfg_class_cond(lambda xx, tt, yy: model.apply(params, xx, tt, yy),
                                         null_label=10, scale=0.4, enabled=True)
            solver = DPMSolver(lambda xx, tt, mask_token=None, cfg_on=True: cfg_fn(
                xx, tt * n_train, cond, cfg_on=cfg_on), ns, predict_x0=True, accel_tau=accel,
                cfg_interval=interval)
            z0 = solver.sample(z, steps=STEPS, eps=1.0 / 1000, T=1.0, order=3, method="fast")
            pm = None
        img = jvae.apply(vae_params, z0, method="decode")
        return img, pm, z0

    return lambda cond, z, m: run(params, jvae_params, cond, z, m)


CASES = [("trained", "exactA"), ("trained", "accel=0.2"), ("trained", "interval=0.0,0.5"),
         ("trained_panoptic", "exactA"), ("trained_panoptic", "accel=0.2"),
         ("trained_panoptic", "interval=0.0,0.5"), ("trained_panoptic", "ihold=0.5,1.0")]


@pytest.mark.parametrize("geo,spec", CASES)
def test_gate_pipeline_matches_jax(gate, geo, spec):
    panoptic = geo == "trained_panoptic"
    accel, interval, gelu, _, hold = pqg.parse_spec(spec)
    build = pqg._build_trained_panoptic if panoptic else pqg._build_trained
    args = (BATCH, accel, interval, gelu, STEPS) + ((hold,) if panoptic else ())
    pipe = build(*args, geo=geo, device="cpu", geo_dims=TINY, vae=gate["vae"])
    rng = np.random.default_rng(11)
    z = rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32)
    m = rng.standard_normal((BATCH, 16, 16, 8)).astype(np.float32) if panoptic else None
    cond = pipe.cond(0)
    img, pm, z0 = pipe(cond, torch.from_numpy(z).permute(0, 3, 1, 2),
                       None if m is None else torch.from_numpy(m).permute(0, 3, 1, 2))
    jrun = _jax_pipeline(panoptic, _jax_params(panoptic, gate["models"][geo]), gate["jvae"],
                         gate["jvae_params"], accel, interval, hold)
    jimg, jpm, jz0 = jrun(jnp.asarray(cond.numpy()), jnp.asarray(z),
                          None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(z0.numpy(), np.asarray(jz0), err_msg="z0", **TOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), err_msg="image", **TOL)
    if panoptic:
        np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), err_msg="mask", **TOL)
    else:
        assert pm is None and jpm is None


def _jax_train(panoptic, params, lr, batches, start):
    """JAX's gate step (`scripts/quality_gate.py` train_gate_model /
    train_gate_panoptic) on (key, x0, cond[, pan]) batches, its schedule at
    update `start`: [(losses, params, ema)] after each step."""
    model = _jax_model(panoptic, use_checkpoint=panoptic)
    schedule = JaxSchedule(stable_diffusion_beta_schedule())
    tx = optax.adamw(optax.linear_schedule(0.0, lr, 500), weight_decay=0.03)

    def loss_fn(p, key, x0, cond, pan):
        if panoptic:
            def nnet_fn(xx, tt, mask_token=None, use_ground_truth=False):
                return model.apply(p, xx, tt, cond, mask_token=mask_token,
                                   use_ground_truth=use_ground_truth)

            le, lm = jax_l_simple_panoptic(key, x0, nnet_fn, schedule, pan, mask_bits=8)
            return le.mean() + lm.mean(), (le.mean(), lm.mean())
        n, eps, xn = schedule.sample(key, x0)
        loss = jnp.mean((eps - model.apply(p, xn, n.astype(jnp.float32), cond)) ** 2)
        return loss, (loss,)

    @jax.jit
    def step(params, opt_state, ema, key, x0, cond, pan):
        (_, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, key, x0, cond,
                                                                      pan)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda e, p: 0.999 * e + 0.001 * p, ema, params)
        return params, opt_state, ema, parts

    adam, decay, sched = tx.init(params)
    opt_state = (adam, decay, sched._replace(count=jnp.asarray(start, jnp.int32)))
    ema, out = params, []
    for key, x0, cond, pan in batches:
        params, opt_state, ema, parts = step(params, opt_state, ema, key, x0, cond, pan)
        out.append(([float(v) for v in parts], params, ema))
    return out


def _draws(key, x0, pan):
    """The draws JAX's `Schedule.sample` makes from `key`, channel-last."""
    key_n, key_eps, key_eps_m = jax.random.split(key, 3)
    out = dict(n=jax.random.randint(key_n, (x0.shape[0],), 1, 1001),
               eps=jax.random.normal(key_eps, x0.shape))
    if pan is not None:
        mask = ints_to_analog(jnp.asarray(pan), n=8)
        out["eps_m"] = MASK_NOISE_SCALE * jax.random.normal(key_eps_m, mask.shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("geo", ["trained", "trained_panoptic"])
def test_gate_training_step_matches_optax(geo):
    panoptic = geo == "trained_panoptic"
    torch.manual_seed(5)
    model = (pqg._trained_panoptic_model(False, attn_impl="auto", use_checkpoint=True,
                                         geo_dims=TINY) if panoptic
             else pqg._trained_model(False, attn_impl="auto", geo_dims=TINY))
    _open_zero_convs(model)
    params0 = _jax_params(panoptic, model)
    lr, start = 2e-4, pqg.WARMUP // 2
    trainer = pqg.GateTrainer(model, lr, "cpu", torch.float32)
    trainer.state.step = start
    start_sd = {k: v.detach().numpy().astype(np.float64).copy()
                for k, v in trainer.state.params.items()}
    rs = np.random.RandomState(1)
    pats, masks, ctxs = pqg._context_assets(TINY, 16, 8)
    batches = []
    for i in range(3):
        y = rs.randint(0, 10, 4)
        x0 = (rs.uniform(0.7, 1.3, (4, 1, 1, 1)) * pats[y]
              + 0.25 * rs.normal(size=(4, 8, 8, 4))).astype(np.float32)
        cond = ctxs[y] if panoptic else y.astype(np.int32)
        pan = masks[y][..., None].astype(np.int32) if panoptic else None
        batches.append((jax.random.PRNGKey(40 + i), x0, cond, pan))
    want = _jax_train(panoptic, params0, lr, batches, start)
    for (key, x0, cond, pan), (jparts, jparams, jema) in zip(batches, want):
        parts = trainer.step(torch.from_numpy(x0), torch.from_numpy(np.asarray(cond)).long()
                             if not panoptic else torch.from_numpy(cond),
                             None if pan is None else torch.from_numpy(pan).long(),
                             draws=_draws(key, x0, pan))
        np.testing.assert_allclose([float(v) for v in parts], jparts, **TOL)
        for what, tree, mine in (("params", jparams, trainer.state.params),
                                 ("ema", jema, trainer.state.ema)):
            jsd = _to_port(panoptic, tree)
            assert sorted(jsd) == sorted(mine), what
            for name, w in jsd.items():
                np.testing.assert_allclose(mine[name].detach().numpy(), w,
                                           err_msg=f"{what} {name}", **TOL)
            moved = {k: w.astype(np.float64) - start_sd[k] for k, w in jsd.items()}
            bar = 5e-3 * max(np.abs(d).max() for d in moved.values())
            assert bar > 0, what
            for name, d in moved.items():
                ulp = np.spacing(np.maximum(np.abs(start_sd[name]), np.abs(jsd[name]))
                                 .astype(np.float32)).astype(np.float64)
                err = np.abs(mine[name].detach().numpy().astype(np.float64) - start_sd[name] - d)
                assert (err <= bar + 4 * ulp).all(), (
                    f"{what} change {name}: {err.max():.3e} over {bar:.3e} + 4 ulp")


def _to_port(panoptic, tree):
    from panopticdiffusionmodels_torch.utils.weights import uvit_state_dict, uvit_t2i_state_dict

    tree = jax.tree.map(np.asarray, tree)
    if panoptic:
        return uvit_t2i_state_dict(tree, patch_size=2, mask_patch_size=4)
    return uvit_state_dict(tree, patch_size=2)

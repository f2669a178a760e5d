"""The port's bench (`panopticdiffusionmodels_torch/scripts/bench.py`) against
the root `bench.py` protocol, restated here with the JAX package's modules
(the root script is never imported: it points JAX's compilation cache at a
fixed directory when imported).

- The bf16 VAE decode (`get_model(dtype=bfloat16)`, the SD f8 geometry) on
  shared weights against JAX `get_model(dtype=bfloat16)`: the port's
  deviation from the f32 decode at most 1.25x JAX's, and the two bf16
  decodes within 3e-2 relative of each other (independent bf16 roundings of
  ~1.5e-2 each; the f32 decode is held at rtol 1e-4 in
  test_torch_port_vae.py).
- The bench pipeline built tiny (U-ViT width 32, depth 4, f32 network, small
  bf16 VAE), which is the serving `GenerationPipeline`, exact protocol and
  the recommended mode (tanh GELU, accel 0.2),
  against the JAX protocol on the same weights and noise: latents before the
  decode at rtol 1e-4 / atol 1e-5, images after the bf16 decode at relative
  deviation < 2e-2, and the same count of real network evals.
- `gate_certification` on its four cases (the arming checked first) and on the repo's
  quality_gate/trained_L/report.json; the recommended-mode constants equal
  the root script's (read from its source without running it); `main` prints
  one JSON line with exactly the root script's keys.
"""
import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion.cfg import make_cfg_class_cond as jax_cfg
from panopticdiffusionmodels_tpu.models import UViT as JaxUViT
from panopticdiffusionmodels_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from panopticdiffusionmodels_tpu.models.vae import get_model as jax_get_vae
from panopticdiffusionmodels_tpu.samplers.dpm_solver import DPMSolver as JaxDPMSolver
from panopticdiffusionmodels_tpu.samplers.noise_schedule import NoiseScheduleVP as JaxNS
from panopticdiffusionmodels_tpu.utils.torch_bridge import convert_autoencoder_kl, convert_uvit
from panopticdiffusionmodels_torch.models.layers import Mlp
from panopticdiffusionmodels_torch.models.vae import get_model
from panopticdiffusionmodels_torch.scripts import bench
from panopticdiffusionmodels_torch.serving import GenerationPipeline

ROOT = Path(__file__).resolve().parents[1]
VAE_GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY = dict(depth=4, embed_dim=32, num_heads=4, img_size=8, vae_geometry=VAE_GEOM)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "recommended_mode", "recommended_value",
              "recommended_vs_baseline", "recommended_gate_verdict",
              "recommended_certification"}


def rel_dev(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _vae_params(vae, **geom):
    return convert_autoencoder_kl({k: v.float().numpy() for k, v in vae.state_dict().items()},
                                  **geom)


def test_bf16_vae_decode_matches_jax():
    torch.manual_seed(1)
    vae = get_model(dtype=torch.bfloat16).eval()
    params = _vae_params(vae)
    z = np.random.default_rng(0).standard_normal((2, 4, 4, 4)).astype(np.float32)

    def jax_decode(dtype):
        fn = functools.partial(jax_get_vae(dtype=dtype).apply, method="decode")
        return jax.jit(fn)(params, jnp.asarray(z))

    ref = jax_decode(jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    ref, ref32 = np.asarray(ref, np.float32), np.asarray(jax_decode(jnp.float32))
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 32, 32)
    assert all(p.dtype == torch.float32 for p in vae.parameters())
    out = out.float().permute(0, 2, 3, 1).numpy()
    # Each bf16 decode deviates from the f32 one by its own rounding noise
    # (1.5e-2 here, JAX's 1.7e-2); the port's must be no larger than JAX's
    # (x1.25), and the two, independent, lie within 3e-2 of each other.
    port_noise, jax_noise = rel_dev(out, ref32), rel_dev(ref, ref32)
    assert 1e-3 < port_noise <= 1.25 * jax_noise, (port_noise, jax_noise)
    assert rel_dev(out, ref) < 3e-2


def _jax_protocol(params, vae_params, z, y, steps, accel, gelu):
    """The root bench.py pipeline, restated: CFG 0.4 with null class 1000 as
    one 2x batch, 50-NFE-style order-3 fast DPM-Solver++ (eps 1/1000, T 1),
    then the bf16 VAE decode; returns (latents, images, real evals)."""
    model = JaxUViT(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=4,
                    num_classes=1001, dtype=jnp.float32, scan_blocks=True, attn_impl="xla",
                    gelu_approx=gelu)
    vae = JaxAutoencoderKL(**VAE_GEOM, dtype=jnp.bfloat16)
    count = [0]

    def bump():
        count[0] += 1

    @jax.jit
    def pipeline(params, vae_params, z, y):
        cfg_fn = jax_cfg(lambda xx, tt, yy: model.apply(params, xx, tt, yy),
                         null_label=1000, scale=0.4, enabled=True)

        def model_fn(xx, tt, mask_token=None, cfg_on=True):
            jax.debug.callback(bump)
            return cfg_fn(xx, tt * 1000, y, cfg_on=cfg_on)

        solver = JaxDPMSolver(model_fn, JaxNS("discrete", betas=_betas()), predict_x0=True,
                              accel_tau=accel)
        z0 = solver.sample(z, steps=steps, eps=1.0 / 1000, T=1.0, order=3, method="fast")
        return z0, vae.apply(vae_params, z0, method="decode")

    z0, img = pipeline(params, vae_params, z, y)
    jax.effects_barrier()
    return np.asarray(z0), np.asarray(img, np.float32), count[0]


def _betas():
    from panopticdiffusionmodels_tpu.diffusion.schedule import stable_diffusion_beta_schedule
    return stable_diffusion_beta_schedule()


@pytest.mark.parametrize("recommended", [False, True])
def test_tiny_bench_pipeline_matches_jax_protocol(recommended, monkeypatch):
    steps = 17  # accel 0.2 skips from 17 steps on
    monkeypatch.setenv("BENCH_STEPS", str(steps))
    comps = bench.build_components("cpu", dtype=torch.float32, **TINY)
    config, model, vae = comps
    knobs = bench.RECOMMENDED_KNOBS if recommended else {}
    pipe = bench.build_pipeline(comps, **knobs)
    # the serving pipeline users call, on the components' weights and VAE
    assert isinstance(pipe, GenerationPipeline) and pipe.class_cond and pipe.vae is vae
    assert vae.compute_dtype == torch.bfloat16
    assert (pipe.nnet is model) != recommended  # the recommended mode shares the weights
    assert all(a is b for a, b in zip(pipe.nnet.parameters(), model.parameters()))
    assert {m.approximate for m in pipe.nnet.modules() if isinstance(m, Mlp)} == \
        {"tanh" if recommended else "none"}
    assert pipe.config.sample.sample_steps == steps and config.sample.accel == 0.0
    assert (pipe.config.sample.accel, pipe.config.nnet.gelu_approx) == \
        ((0.2, True) if recommended else (0.0, False))
    params = convert_uvit({k: v.numpy() for k, v in model.state_dict().items()}, depth=4,
                          num_classes=1001, scan_blocks=True)
    vae_params = _vae_params(vae, ch_mult=VAE_GEOM["ch_mult"], num_res_blocks=1)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    y = np.array([5, 1000, 999])
    rz0, rimg, jevals = _jax_protocol(params, vae_params, jnp.asarray(z),
                                      jnp.asarray(y, jnp.int32), steps,
                                      0.2 if recommended else 0.0, recommended)
    latents = []
    vae.decode, decode = (lambda zz: latents.append(zz) or decode(zz)), vae.decode
    img, mask = pipe.sample(torch.from_numpy(z).permute(0, 3, 1, 2), None, torch.from_numpy(y))
    assert mask is None and img.dtype == torch.bfloat16 and img.shape == (3, 3, 16, 16)
    np.testing.assert_allclose(latents[0].permute(0, 2, 3, 1).numpy(), rz0,
                               rtol=1e-4, atol=1e-5)
    assert rel_dev(img.float().permute(0, 2, 3, 1).numpy(), rimg) < 2e-2
    assert pipe.last_real_evals == jevals == (15 if recommended else steps)


def _report(tmp_path, payload):
    path = tmp_path / "report.json"
    path.write_text(json.dumps(payload))
    return path


def test_gate_certification_cases(tmp_path):
    spec = bench.RECOMMENDED_MODE_SPEC
    assert bench.gate_certification(tmp_path / "absent.json", spec) == ("UNMEASURED", False)
    (tmp_path / "report.json").write_text("{not json")
    assert bench.gate_certification(tmp_path / "report.json", spec) == ("UNMEASURED", False)
    assert bench.gate_certification(_report(tmp_path, {"modes": {}, "report_armed": True}),
                                    spec) == ("UNMEASURED", True)
    entry = {"modes": {spec: {"verdict": "PASS"}}}
    assert bench.gate_certification(_report(tmp_path, dict(entry, report_armed=False)),
                                    spec) == ("UNARMED", False)
    assert bench.gate_certification(_report(tmp_path, dict(entry, report_armed=True)),
                                    spec) == ("PASS", True)
    rep = json.loads((ROOT / "quality_gate" / "trained_L" / "report.json").read_text())
    want = (rep["modes"][spec]["verdict"], True) if rep.get("report_armed") else \
        ("UNARMED", False)
    assert bench.REPORT == ROOT / "quality_gate" / "trained_L" / "report.json"
    assert bench.gate_certification(bench.REPORT, spec) == want == ("PASS", True)


@pytest.mark.parametrize("payload,want", [
    ({"modes": {}, "report_armed": False}, ("UNARMED", False)),
    ({"modes": {}}, ("UNARMED", False)),
    ({"modes": {"<spec>": {"tv": 0.1}}, "report_armed": True}, ("UNMEASURED", True)),
], ids=["unarmed-mode-absent", "arming-absent-mode-absent", "armed-entry-without-verdict"])
def test_gate_certification_checks_arming_first(tmp_path, payload, want):
    """The arming is checked before the mode, so an unarmed report that never
    gated the mode is not certifiable; an armed entry without a verdict is
    unmeasured, not a KeyError (the root bench.py differs on both)."""
    spec = bench.RECOMMENDED_MODE_SPEC
    payload = json.loads(json.dumps(payload).replace("<spec>", spec))
    assert bench.gate_certification(_report(tmp_path, payload), spec) == want


def test_constants_equal_the_root_bench():
    tree = ast.parse((ROOT / "bench.py").read_text())
    consts = {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}
    for name in ("A100_BASELINE_EST", "RECOMMENDED_MODE_NAME", "RECOMMENDED_MODE_SPEC"):
        assert ast.literal_eval(consts[name]) == getattr(bench, name), name
    knobs = consts["RECOMMENDED_KNOBS"]
    assert {k.arg: ast.literal_eval(k.value) for k in knobs.keywords} == bench.RECOMMENDED_KNOBS


@pytest.mark.parametrize("recommended", ["on", "off"])
def test_main_prints_the_root_bench_keys(recommended, monkeypatch, capsys):
    for k, v in dict(BENCH_BATCH="2", BENCH_REPS="1", BENCH_STEPS="3",
                     BENCH_RECOMMENDED=recommended).items():
        monkeypatch.setenv(k, v)
    record = bench.main(bench.build_components("cpu", **TINY))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    want = BENCH_KEYS if recommended == "on" else {"metric", "value", "unit", "vs_baseline"}
    assert set(record) == want
    assert record["metric"] == "imagenet256_uvitL_50step_dpmpp_cfg_images_per_sec_per_chip"
    assert record["value"] > 0
    assert abs(record["vs_baseline"] - record["value"] / bench.A100_BASELINE_EST) < 1e-3

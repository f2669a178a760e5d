"""The quality gate's host side (`panopticdiffusionmodels_torch/scripts/
quality_gate.py`) against the JAX package's `scripts/quality_gate.py`,
loaded by path as `tests/test_quality_gate.py` loads it (its JAX
compilation-cache settings are put back after the load):

  * `parse_spec` of every kind of spec, and the unknown one, equal;
  * `_class_patterns`, `_structured_batch`, `_panoptic_class_assets` (the
    256 and 512 geometries) and `_latent_stats` equal exactly;
  * both `report`s on the same .npz files, in each scenario of the JAX
    tests (the ladder, unarmed, a channel that misses its doses, mask TV,
    armed KID, KID without acts, latent TV, no latent channel, a degenerate
    control): the same report.json, floats to rel 1e-9, and the same
    warnings;
  * files written by the port's `run_spec` (a tiny trained_panoptic
    geometry on the CPU: one training step, 50-step sampling of 4 images a
    spec, a 16-feature random projection for Inception) read by JAX's
    `report` give the port's report.json.
"""
import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from panopticdiffusionmodels_torch.scripts import quality_gate as pqg

REPO = Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jqg():
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("quality_gate_jax",
                                                  REPO / "scripts" / "quality_gate.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


SPECS = ["exactA", "exactB", "exactC", "gelu", "accel=0.2", "gelu_accel=0.2",
         "interval=0.0,0.5", "ihold=0.5,1.0", "combo=0.2:0.0,0.5", "full=0.3:0.1,0.6",
         "full_hold=0.2:0.5,1.0", "steps=25", "steps=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec(jqg, spec):
    assert pqg.parse_spec(spec) == jqg.parse_spec(spec)


def test_parse_spec_unknown(jqg):
    for mod in (jqg, pqg):
        with pytest.raises(SystemExit):
            mod.parse_spec("bogus=1")


def test_constants(jqg):
    assert pqg.SEEDS == jqg.SEEDS and pqg.MODE_SEED == jqg.MODE_SEED
    assert pqg._GEO_SCALE == jqg._GEO_SCALE and pqg.Q_BINS == jqg.Q_BINS
    assert (pqg.TV_CTRL_PASS, pqg.TV_CTRL_MARGINAL, pqg.CONTROL_SPEC) == \
        (jqg.TV_CTRL_PASS, jqg.TV_CTRL_MARGINAL, jqg.CONTROL_SPEC)
    assert pqg._instance_seed() == jqg._instance_seed()
    for geo in ("trained_panoptic", "trained_panoptic_512"):
        assert pqg._panoptic_geo_dims(geo) == jqg._panoptic_geo_dims(geo)


@pytest.mark.parametrize("size", [32, 64])
def test_class_patterns_and_batches_equal(jqg, size):
    np.testing.assert_array_equal(pqg._class_patterns(size=size), jqg._class_patterns(size=size))
    a = pqg._structured_batch(np.random.RandomState(7), 16)
    b = jqg._structured_batch(np.random.RandomState(7), 16)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("geo", ["trained_panoptic", "trained_panoptic_512"])
def test_panoptic_class_assets_equal(jqg, geo):
    size, msize = jqg._panoptic_geo_dims(geo)
    for x, y in zip(pqg._panoptic_class_assets(mask=msize, size=size),
                    jqg._panoptic_class_assets(mask=msize, size=size)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_latent_stats_equal(jqg):
    pats = jqg._class_patterns()
    rs = np.random.RandomState(3)
    y = rs.randint(0, 10, 64)
    for z in (pats[y] + 0.05 * rs.normal(size=(64, 32, 32, 4)),
              rs.normal(size=(64, 32, 32, 4))):
        for x, w in zip(pqg._latent_stats(z, pats), jqg._latent_stats(z, pats)):
            np.testing.assert_array_equal(x, w)


# --- both reports on the same files ------------------------------------------


def _name(spec):
    return f"{spec.replace(':', '_').replace(',', '-')}.npz"


def _write_run(out, spec, mu, sigma, mask_hist=None, n=256):
    np.savez(os.path.join(out, _name(spec)), mu=mu, sigma=sigma,
             mask_hist=np.zeros(256, np.int64) if mask_hist is None else mask_hist,
             n=n, wall=1.0, spec=spec)


def _write_acts_run(out, spec, acts):
    acts = np.asarray(acts, np.float32)
    np.savez(os.path.join(out, _name(spec)), mu=acts.mean(0), sigma=np.cov(acts, rowvar=False),
             mask_hist=np.zeros(256, np.int64), n=len(acts), wall=1.0, spec=spec, acts=acts)


def _write_latent_run(out, spec, class_hist, q_hist, d=4, n=256):
    np.savez(os.path.join(out, _name(spec)), mu=np.zeros(d), sigma=np.eye(d),
             mask_hist=np.zeros(256, np.int64), n=n, wall=1.0, spec=spec,
             latent_class_hist=np.asarray(class_hist, np.int64),
             latent_q_hist=np.asarray(q_hist, np.int64))


def _ladder(out):
    d, sigma = 8, np.eye(8)
    for spec, delta in (("exactA", 0.0), ("exactB", 0.01), ("steps=25", 0.01),
                        ("steps=10", 0.10), ("modepass", 0.01), ("modemarginal", 0.018),
                        ("modefail", 0.05)):
        _write_run(out, spec, np.full(d, delta), sigma)


def _unarmed(out):
    for spec, delta in (("exactA", 0.0), ("exactB", 0.01), ("modeclean", 0.01)):
        _write_run(out, spec, np.full(8, delta), np.eye(8))


def _misses_doses(out):
    for spec, delta in (("exactA", 0.0), ("exactB", 0.01), ("steps=25", 0.01),
                        ("steps=10", 0.012), ("modeclean", 0.01)):
        _write_run(out, spec, np.full(8, delta), np.eye(8))


def _hists():
    base = np.zeros(256, np.int64)
    base[:4] = [700, 100, 100, 100]
    jitter, shifted = base.copy(), base.copy()
    jitter[:4] = [690, 110, 100, 100]
    shifted[:4] = [100, 700, 100, 100]
    return base, jitter, shifted


def _mask_tv(out):
    base, jitter, shifted = _hists()
    for spec, h in (("exactA", base), ("exactB", jitter), ("steps=25", jitter),
                    ("steps=10", shifted), ("modeshift", shifted)):
        _write_run(out, spec, np.zeros(4), np.eye(4), mask_hist=h)


def _degenerate(out):
    base, jitter, shifted = _hists()
    for spec, h in (("exactA", base), ("exactB", jitter), ("steps=25", base),
                    ("steps=10", shifted), ("modeshift", shifted)):
        _write_run(out, spec, np.zeros(4), np.eye(4), mask_hist=h)


def _kid_armed(out):
    d, n = 512, 256
    rs = np.random.RandomState(0)
    a, b = rs.normal(size=(n, d)), rs.normal(size=(n, d))
    shifted = rs.normal(size=(n, d)) + 0.15
    _write_acts_run(out, "exactA", a)
    _write_acts_run(out, "exactB", b)
    _write_acts_run(out, "steps=25", rs.normal(size=(n, d)))
    _write_acts_run(out, "steps=10", rs.normal(size=(n, d)) + 0.3)
    _write_acts_run(out, "modeshift", shifted)
    _write_acts_run(out, "modeok", a + 0.001 * rs.normal(size=(n, d)))


def _kid_without_acts(out):
    rs = np.random.RandomState(1)
    _write_acts_run(out, "exactA", rs.normal(size=(64, 32)))
    _write_run(out, "exactB", np.zeros(32), np.eye(32))
    _write_run(out, "modex", np.zeros(32), np.eye(32))


def _latent_tv(out):
    qh = np.zeros(pqg.Q_BINS, np.int64)
    qh[28] = 1000

    def q_shifted(k):
        h = qh.copy()
        h[28] -= k
        h[27] += k
        return h

    cls = np.full(10, 100, np.int64)
    bad_q = np.zeros(pqg.Q_BINS, np.int64)
    bad_q[2] = 1000
    for spec, h in (("exactA", qh), ("exactB", q_shifted(4)), ("steps=25", q_shifted(10)),
                    ("steps=10", bad_q), ("modegood", q_shifted(15)), ("modebad", bad_q)):
        _write_latent_run(out, spec, cls, h)


def _no_latent(out):
    for spec in ("exactA", "exactB", "modex"):
        _write_run(out, spec, np.zeros(4), np.eye(4))


SCENARIOS = dict(ladder=_ladder, unarmed=_unarmed, misses_doses=_misses_doses, mask_tv=_mask_tv,
                 kid_armed=_kid_armed, kid_without_acts=_kid_without_acts, latent_tv=_latent_tv,
                 no_latent=_no_latent, degenerate=_degenerate)


def assert_same(got, want, path="report"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, rel=1e-9, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, path


def _both_reports(jqg, out, capsys):
    mine = Path(f"{out}_port")
    shutil.copytree(out, mine)
    # one BLAS thread: the 512-d `sqrtm`s crawl when pytest's workers share the cores
    with threadpool_limits(1):
        jqg.report("testgeo", str(out))
        jax_out = capsys.readouterr().out
        pqg.report("testgeo", str(mine))
        port_out = capsys.readouterr().out
    with open(os.path.join(out, "report.json")) as f:
        want = json.load(f)
    with open(mine / "report.json") as f:
        got = json.load(f)
    assert_same(got, want)
    return got, port_out, jax_out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_reports_agree(jqg, scenario, tmp_path, capsys):
    out = tmp_path / "runs"
    out.mkdir()
    SCENARIOS[scenario](str(out))
    got, port_out, jax_out = _both_reports(jqg, out, capsys)
    for word in ("degenerate", "NO channel is armed"):
        assert (word in port_out) == (word in jax_out), word
    if scenario == "ladder":
        assert got["report_armed"] is True
        assert [got["modes"][m]["verdict"] for m in ("modepass", "modemarginal", "modefail")] \
            == ["PASS", "MARGINAL", "FAIL"]
    if scenario == "degenerate":
        assert "degenerate" in port_out and got["tv_control_25nfe"] == 0.0


# --- the port's run files, read by JAX's report ----------------------------

TINY = pqg.Geometry(size=8, embed_dim=32, depth=4, num_heads=4, mask=16, clip_dim=16,
                    clip_tokens=7, vae=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                            scale_factor=0.2301), dtype=torch.float32)


def test_run_spec_files_read_by_jax_report(jqg, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("QG_DIR", str(tmp_path))
    geo = "trained_panoptic"
    pqg.train_gate_panoptic(1e9, batch=4, geo=geo, device="cpu", geo_dims=TINY, max_steps=1)
    assert os.path.exists(tmp_path / f"{geo}_params.pt")
    proj = torch.from_numpy(np.random.default_rng(0).normal(size=(16 * 16 * 3, 16))
                            .astype(np.float32))

    def extractor(img01):
        return img01.reshape(img01.shape[0], -1) @ proj

    out = tmp_path / geo
    for spec in ("exactA", "exactB", "steps=25", "steps=3"):
        fields = pqg.run_spec(geo, spec, str(out), 4, 4, device="cpu", geo_dims=TINY,
                              extractor=extractor)
        assert fields["acts"].shape == (4, 16) and fields["mask_hist"].sum() == 4 * 16 * 16
        assert fields["latent_class_hist"].sum() == 4
    with np.load(out / "steps=3.npz") as f:
        assert sorted(f.files) == sorted(["mu", "sigma", "mask_hist", "n", "wall", "spec",
                                          "acts", "latent_class_hist", "latent_q_hist"])
        assert str(f["spec"]) == "steps=3" and int(f["n"]) == 4
    got, _, _ = _both_reports(jqg, out, capsys)
    assert got["n"] == 4 and got["tv_floor"] is not None and got["kid_floor"] is not None
    assert sorted(got["modes"]) == ["steps=25", "steps=3"]

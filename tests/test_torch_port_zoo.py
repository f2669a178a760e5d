"""The port's config zoo against the JAX zoo, field by field, and the speed
-mode guardrail on the pixel configs.

Every name the port has that the JAX zoo has too must agree in every field
and value (tuples and lists alike), apart from the backend-only fields
`nnet.attn_impl`, `nnet.scan_blocks` and the port's `mesh.sp_mode`.  The
port-only CPU configs are named here, so a new port-only name is a choice,
not an accident.  `check_speed_modes` must give the pixel configs the same
warnings as JAX's on every config but one: the port's key adds the input
channels and the patch size, so U-ViT-L/4 at 64x64 pixels no longer reads
the entry of the latent ImageNet-512 L/4, whose JAX key it shares, and warns
that it was never measured.
"""
import pytest

from panopticdiffusionmodels_tpu.configs import CONFIG_NAMES as JAX_NAMES
from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.samplers import speed_budget as jax_budget
from panopticdiffusionmodels_torch.configs import CONFIG_NAMES, get_config
from panopticdiffusionmodels_torch.samplers import speed_budget

PORT_ONLY = {"synthetic_tiny_cond", "synthetic_tiny_pixel"}
EXEMPT = {("nnet", "attn_impl"), ("nnet", "scan_blocks"), ("mesh", "sp_mode")}
PIXEL = ["cifar10_uvit_small", "celeba64_uvit_small", "imagenet64_uvit_mid",
         "imagenet64_uvit_large"]


def plain(value, path=()):
    """Nested dicts of lists, without the exempt fields."""
    if hasattr(value, "to_dict"):
        value = value.to_dict()
    if isinstance(value, dict):
        return {k: plain(v, path + (k,)) for k, v in value.items()
                if path + (k,) not in EXEMPT}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def test_port_names_are_jax_names_or_port_only():
    assert set(CONFIG_NAMES) - set(JAX_NAMES) == PORT_ONLY
    assert set(PIXEL) <= set(CONFIG_NAMES)


@pytest.mark.parametrize("name", sorted(set(CONFIG_NAMES) - PORT_ONLY))
def test_config_matches_jax_field_by_field(name):
    ours, ref = plain(get_config(name)), plain(jax_get_config(name))
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key] == ref[key], (name, key, ours[key], ref[key])


MODES = [dict(accel=0.2), dict(cfg_interval=(0.0, 0.5)), dict(gelu_approx=True),
         dict(accel=0.1, gelu_approx=True), dict()]


def _warnings(name, mode):
    """check_speed_modes' warnings for config `name` with `mode` in the port
    and in JAX."""
    ours, ref = get_config(name), jax_get_config(name)
    for c in (ours, ref):
        c.sample.accel = mode.get("accel", 0.0)
        c.sample.cfg_interval = mode.get("cfg_interval", ())
        c.nnet.gelu_approx = mode.get("gelu_approx", False)
    return (speed_budget.check_speed_modes(ours, log=False),
            jax_budget.check_speed_modes(ref, log=False))


def _same_outcome(got, want):
    return len(got) == len(want) and all(g.split(" ")[0] == w.split(" ")[0]
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("name", PIXEL)
def test_speed_modes_on_pixel_configs_match_jax(name):
    for mode in MODES:
        got, want = _warnings(name, mode)
        key = speed_budget._geometry_key(get_config(name))
        if name == "imagenet64_uvit_large":  # the repaired key: never measured
            assert key not in speed_budget._VALIDATED
            assert len(got) == (1 if mode else 0), (mode, got)
        else:
            assert _same_outcome(got, want), (mode, got, want)
        if mode and key not in speed_budget._VALIDATED:
            assert "NO measured deviation entry" in got[0]


@pytest.mark.parametrize("name", sorted(set(CONFIG_NAMES) - PORT_ONLY - {"imagenet64_uvit_large"}))
def test_speed_modes_keep_jax_outcome(name):
    """Every config of both zoos but imagenet64_uvit_large gets JAX's
    warnings for every mode."""
    for mode in MODES:
        got, want = _warnings(name, mode)
        assert _same_outcome(got, want), (mode, got, want)


def test_imagenet64_large_shares_the_l4_key():
    """Named for what JAX's key does, which the port's no longer does: the
    key holds the input channels and the patch size, so U-ViT-L/4 on
    64x64 pixels (3 channels) no longer reads ImageNet-512's latent L/4
    entry (4 channels), which JAX's key gives it, and warns at the
    recommended accel 0.2 + gelu; the latent L/4 keeps its entry."""
    keys = {n: speed_budget._geometry_key(get_config(n)) for n in PIXEL}
    assert keys["imagenet64_uvit_large"] == ("uvit", 1024, 20, False, 64, 3, 4)
    assert speed_budget._geometry_key(get_config("imagenet512_uvit_large")) in \
        speed_budget._VALIDATED
    assert [n for n in PIXEL if keys[n] in speed_budget._VALIDATED] == []
    got, want = _warnings("imagenet64_uvit_large", dict(accel=0.2, gelu_approx=True))
    assert want == [] and len(got) == 1 and "NO measured deviation entry" in got[0], got

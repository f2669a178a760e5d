"""The port's FID Inception (evaluation/inception.py) against the JAX package's
on the same weights: `random_params` carried by `inception_state_dict`, every
mixed block on one input, and pool3 without a resize (75 x 75), upsampled to
299 (32 x 32) and downsampled to 299 (320 x 320, antialiased).  f32 on the
CPU; tolerance rtol 1e-4 / atol 1e-5 relative to each output's scale (the
features of random weights are ~1e-2), which every case meets by two orders
(measured: relative deviation <= 2e-6, the 320 -> 299 resize alone <= 1.2e-5
absolute on [0, 1] pixels)."""
import jax
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.evaluation import inception as jax_inception
from panopticdiffusionmodels_torch.evaluation import inception

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def weights():
    params = jax_inception.random_params(0)
    model = inception.from_state_dict(inception.inception_state_dict(params)).eval()
    return params, model


def close(ours, ref, rtol=RTOL, atol=ATOL):
    """allclose with atol scaled to the reference's magnitude."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1e-3))


def test_random_state_dict_is_the_carried_jax_random_params(weights):
    params, _ = weights
    carried = inception.inception_state_dict(params)
    ours = inception.random_state_dict(0)
    assert sorted(ours) == sorted(carried)
    for k, v in carried.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["Conv2d_1a_3x3.conv.weight"].shape == (32, 3, 3, 3)
    assert ours["Mixed_7c.branch_pool.conv.weight"].shape == (192, 2048, 1, 1)


BLOCKS = [("Mixed_5b", 192, jax_inception._inception_a, {}),
          ("Mixed_6a", 288, jax_inception._inception_b, {}),
          ("Mixed_6e", 768, jax_inception._inception_c, {}),
          ("Mixed_7a", 768, jax_inception._inception_d, {}),
          ("Mixed_7b", 1280, jax_inception._inception_e, {"pool": "avg"}),
          ("Mixed_7c", 2048, jax_inception._inception_e, {"pool": "max"})]


@pytest.mark.parametrize("name,cin,jax_block,kw", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_mixed_block_matches_jax(weights, name, cin, jax_block, kw):
    params, model = weights
    x = np.random.default_rng(1).standard_normal((2, 9, 9, cin)).astype(np.float32)
    ref = np.asarray(jax_block(params[name], x, **kw))
    with torch.no_grad():
        ours = getattr(model, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(ours.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("shape,resize", [((2, 75, 75, 3), False), ((2, 32, 32, 3), True),
                                          ((1, 320, 320, 3), True)],
                         ids=["75-no-resize", "32-to-299", "320-to-299-antialias"])
def test_pool3_matches_jax(weights, shape, resize):
    params, model = weights
    x = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jax_inception.inception_pool3(p, v, resize=resize))(
        params, x))
    if resize:
        ours = inception.make_extractor(model, device="cpu")(x).numpy()
        resized = jax.image.resize(x, (x.shape[0], 299, 299, 3), "bilinear")
        port_resized = inception.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(port_resized.permute(0, 2, 3, 1).numpy(), resized,
                                   atol=5e-5)
    else:
        with torch.no_grad():
            ours = model(torch.from_numpy(x).permute(0, 3, 1, 2), resize=False).numpy()
    assert ours.shape == (shape[0], 2048)
    close(ours, ref)


def _save(sd, path):
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, path)


def test_load_inception_weights_drops_heads_and_is_strict(tmp_path, weights):
    _, model = weights
    sd = inception.random_state_dict(0)
    extra = dict(sd, **{"fc.weight": np.zeros((1008, 2048), np.float32),
                        "fc.bias": np.zeros(1008, np.float32),
                        "AuxLogits.fc.weight": np.zeros((1000, 768), np.float32),
                        "Mixed_5b.branch1x1.bn.num_batches_tracked": np.zeros((), np.int64)})
    _save(extra, tmp_path / "pt_inception.pth")
    loaded = inception.load_inception_weights(str(tmp_path / "pt_inception.pth"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    missing = {k: v for k, v in sd.items() if k != "Mixed_6b.branch7x7_2.conv.weight"}
    _save(missing, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        inception.load_inception_weights(str(tmp_path / "missing.pth"))
    _save(dict(sd, **{"Mixed_5b.extra.weight": np.zeros(3, np.float32)}),
          tmp_path / "unexpected.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        inception.load_inception_weights(str(tmp_path / "unexpected.pth"))


def test_extractor_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inception.make_extractor(weights[1])


def test_no_tf32_is_scoped():
    before = torch.backends.cudnn.allow_tf32
    with inception.no_tf32():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before

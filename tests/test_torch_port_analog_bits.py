"""The port's analog-bit codec against the JAX package's (MSB = channel 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticdiffusionmodels_tpu.diffusion import analog_bits as jax_bits
from panopticdiffusionmodels_torch.diffusion import analog_bits


@pytest.mark.parametrize("channels", [1, 3])
def test_codec_matches_jax_and_round_trips(channels):
    ids = np.random.default_rng(channels).integers(0, 256, (2, 5, 7, channels)).astype(np.int32)
    bits = analog_bits.int2bits(torch.from_numpy(ids))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax_bits.int2bits(jnp.asarray(ids))))
    analog = analog_bits.ints_to_analog(torch.from_numpy(ids))
    np.testing.assert_array_equal(analog.numpy(),
                                  np.asarray(jax_bits.ints_to_analog(jnp.asarray(ids))))
    back = analog_bits.analog_to_ints(analog)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), ids)


def test_threshold_matches_jax_on_noisy_bits():
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 8)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # exactly 0 reads as bit 0 on both sides
    ours = analog_bits.analog_to_ints(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_bits.analog_to_ints(jnp.asarray(x))))
    assert ours.shape == (2, 4, 4, 1)

"""The port's boot-time write path (``core/write_path.py``) against the
JAX package's, on the CPU: frames bit for bit on seeded int8 blobs of
several sizes (one frame, a partial last frame, an exact multiple), the
round trip exact, and the register and boot-time models equal."""
import numpy as np
import pytest

from repro.configs import CNN_CONFIGS as JAX_CNN_CONFIGS
from repro.core import write_path as jax_write_path
from repro_torch.configs.cnn import CNN_CONFIGS
from repro_torch.core import write_path

FRAME = 224 * 224 * 3


@pytest.mark.parametrize("n", [1, 1000, FRAME - 1, FRAME, FRAME + 1,
                               3 * FRAME, 2 * FRAME + 12_345])
def test_frames_equal_the_jax_package(n):
    w = np.random.default_rng(n).integers(-127, 128, size=n, dtype=np.int8)
    got = write_path.pack_weights_as_images(w)
    want = jax_write_path.pack_weights_as_images(w)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape == (-(-n // FRAME), 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(write_path.unpack_weights(got, n), w)
    assert not got.reshape(-1)[n:].any()          # zero padding


@pytest.mark.parametrize("width", [8, 30, 64, 256])
def test_registers_equal_the_jax_package(width):
    assert write_path.write_path_registers(width) == \
        jax_write_path.write_path_registers(width)
    assert write_path.registers_saved(width) == \
        jax_write_path.registers_saved(width)
    assert write_path.registers_saved(30) > 3000   # the paper's claim


@pytest.mark.parametrize("burst", [1, 8, 32])
@pytest.mark.parametrize("width", [30, 256])
@pytest.mark.parametrize("net", ["resnet50", "vgg16"])
def test_boot_time_equals_the_jax_package(net, width, burst):
    nbytes = CNN_CONFIGS[net].total_weight_bits() // 8
    assert nbytes == JAX_CNN_CONFIGS[net].total_weight_bits() // 8
    assert write_path.boot_time_s(nbytes, width, burst) == \
        jax_write_path.boot_time_s(nbytes, width, burst)
    assert 0.01 < write_path.boot_time_s(nbytes) < 60.0

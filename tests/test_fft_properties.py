"""Mathematical property tests for every FFT backend: linearity, unitarity
(Parseval up to the unnormalized factor), impulse/DC responses, and
round-trip with the forward transform."""

import numpy as np
import jax.numpy as jnp
import pytest

from jax import lax

from tpu_ocean.fft import get_ifft2
from tpu_ocean.fft.reference import ifft2_planes
from tpu_ocean.fft.stockham import fft2_stockham
from tpu_ocean.fft.matmul import fft2_matmul

#: the three backends, plus "planes": fft.reference's (re, im) plane API
#: that the real-state, cascade and sharded paths call
BACKENDS = ["reference", "stockham", "matmul", "planes"]
N = 32


def _ifft2(backend):
    if backend == "planes":
        return lambda x: lax.complex(*ifft2_planes(jnp.real(x),
                                                   jnp.imag(x)))
    return get_ifft2(backend, N)


def _rand(seed, shape=(2, N, N)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("backend", BACKENDS)
def test_linearity(backend):
    f = _ifft2(backend)
    a, b = _rand(0), _rand(1)
    lhs = np.asarray(f(jnp.asarray(2.0 * a + 3.0 * b)))
    rhs = 2.0 * np.asarray(f(jnp.asarray(a))) + 3.0 * np.asarray(f(jnp.asarray(b)))
    np.testing.assert_allclose(lhs, rhs, atol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dc_impulse(backend):
    f = _ifft2(backend)
    # spectrum = delta at k=0 → constant field of 1 (unnormalized inverse)
    x = np.zeros((1, N, N), np.complex64)
    x[0, 0, 0] = 1.0
    out = np.asarray(f(jnp.asarray(x)))
    np.testing.assert_allclose(out, 1.0 + 0j, atol=1e-5)
    # constant spectrum → N² spike at the origin
    y = np.ones((1, N, N), np.complex64)
    out = np.asarray(f(jnp.asarray(y)))
    assert abs(out[0, 0, 0] - N * N) < 1e-2
    assert np.abs(out[0, 1:, 1:]).max() < 1e-2


@pytest.mark.parametrize("backend", BACKENDS)
def test_parseval(backend):
    """Σ|F|² = N² Σ|X|² for the unnormalized inverse transform."""
    f = _ifft2(backend)
    x = _rand(2, (1, N, N))
    out = np.asarray(f(jnp.asarray(x)))
    np.testing.assert_allclose(np.sum(np.abs(out) ** 2),
                               N * N * np.sum(np.abs(x) ** 2), rtol=1e-5)


@pytest.mark.parametrize("fwd,name", [
    (fft2_stockham, "stockham"),
    (fft2_matmul, "matmul"),
    (jnp.fft.fft2, "planes"),
])
def test_roundtrip_forward_inverse(fwd, name):
    """ifft2(fft2(x)) == N²·x for each backend pair."""
    inv = _ifft2(name)
    x = _rand(3, (1, N, N))
    back = np.asarray(inv(jnp.asarray(np.asarray(fwd(jnp.asarray(x))))))
    np.testing.assert_allclose(back, N * N * x, atol=1e-2)

"""jnp.fft-based 2-D inverse transforms — the solver's FFT (SURVEY.md §7).

All solver FFT backends implement the UNNORMALIZED inverse DFT

    F[i, j] = Σ_{n,m} X[n, m] · e^{+2πi(ni + mj)/N}

because the oracle sums e^{+i k·x} with no normalization (FFTMesh.cs:205-211);
SURVEY.md §3.3: "e^{+ik·x} ⇒ match with an unnormalized inverse DFT".
``norm="forward"`` asks jnp.fft for exactly that scaling (no 1/N on the
inverse). XLA lowers these calls to the device's FFT library (cuFFT on a GPU).

The plane API (``ifft2_planes`` / ``ifft2_planes_half``) takes and returns
(re, im) float32 planes: the real-state, cascade, LOD, velocity and sharded
paths keep their state and spectra as separate f32 planes, and these wrappers
are the one place they meet the complex transform.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from tpu_ocean.grids import centered_ifft_factors


def ifft2_unnorm(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized inverse FFT over the last two axes (any leading batch)."""
    return jnp.fft.ifft2(x, norm="forward")


def ifft2_planes(re: jnp.ndarray, im: jnp.ndarray):
    """Unnormalized inverse 2-D transform of a spectrum given as (re, im)
    f32 planes [..., N0, N1] → (re, im) spatial planes of the same shape."""
    f = jnp.fft.ifft2(lax.complex(re, im), norm="forward")
    return jnp.real(f), jnp.imag(f)


def irfft2_half(x: jnp.ndarray) -> jnp.ndarray:
    """Half-spectrum (C2R) unnormalized inverse transform: ``x`` [..., N/2+1,
    N] holds spectral rows k1 = 0..N/2 of a HERMITIAN spectrum (S[−k] =
    conj S[k]); returns the REAL spatial field [..., N, N]. The conjugate
    rows N/2+1..N−1 are implied, so the k1 axis is the one the real
    transform runs over (axis −2), after a full complex pass along k2."""
    mp1, n = x.shape[-2], x.shape[-1]
    if 2 * (mp1 - 1) != n:
        raise ValueError(f"half-spectrum input must carry N/2+1 rows; "
                         f"got {mp1} for N={n}")
    return jnp.fft.irfft2(x, s=(n, n), axes=(-1, -2), norm="forward")


def ifft2_planes_half(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Plane form of :func:`irfft2_half`: (re, im) [..., N/2+1, N] → real
    [..., N, N]."""
    return irfft2_half(lax.complex(re, im))


def centered_modulation(n: int, length: float, unit_width: float, dtype=np.complex64):
    """(pre[N,N], post[N,N]) modulation grids for the centered-grid transform.

    See grids.centered_ifft_factors: converts a standard-index IFFT into the
    oracle's centered sum Σ H e^{i·2π(n−N/2)(i−N/2+η)/N} evaluated at the
    reference mesh positions (FFTMesh.cs:111-112,201-204). Requires
    length == n · unit_width.
    """
    if abs(length - n * unit_width) > 1e-9 * max(1.0, length):
        raise ValueError(
            f"centered FFT evaluation requires length == resolution*unit_width "
            f"(got L={length}, N*w={n * unit_width}); use the 'direct' "
            f"evaluation mode for incommensurate grids")
    pre1, post1 = centered_ifft_factors(n, length, unit_width)
    pre = np.outer(pre1, pre1)
    post = np.outer(post1, post1)
    # host numpy: the solvers device_put these once and pass them to the
    # jitted step as arguments (an N² constant embedded in the program
    # slows compilation and bloats the executable)
    return np.asarray(pre, dtype=dtype), np.asarray(post, dtype=dtype)

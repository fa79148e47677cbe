"""2-D (inverse) FFT backends for the spectral solver (components C8/C9).

Backends, all computing the UNNORMALIZED inverse transform
F[i,j] = Σ_{n,m} X[n,m] e^{+2πi(ni+mj)/N} over the trailing two axes:

* ``reference``  — jnp.fft (XLA's FFT, the device FFT library); the solver's
                   default and the only backend of the plane pipelines
                   (real_state, half_spectrum, cascades, sharded planes).
* ``stockham``   — pure-JAX radix-2 Stockham stage loop, the re-expression
                   of Stockham.shader + the OceanRenderer pass scheduler as
                   one traced loop.
* ``matmul``     — DFT as dense matmuls (four-step), under the precision
                   policy of fft.matmul._dot.
* ``distributed``— shard_map row/col decomposition with all_to_all transpose
                   (fft.distributed), over any of the local backends above.
"""

import functools

from tpu_ocean.fft.reference import ifft2_unnorm, centered_modulation

BACKENDS = ("reference", "stockham", "matmul")


def check_backend(backend: str) -> None:
    """Raise ValueError naming the valid backends for an unknown one."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown fft backend {backend!r}; "
                         f"choose from {BACKENDS}")


def get_ifft2(backend: str, n: int, precision: str = "float32"):
    """Return fn(x[..., N, N] complex) -> unnormalized inverse FFT2.
    ``precision`` reaches the matmul backend only (the others have no dot
    products)."""
    check_backend(backend)
    if backend == "reference":
        return ifft2_unnorm
    if backend == "stockham":
        from tpu_ocean.fft.stockham import ifft2_stockham
        return ifft2_stockham
    from tpu_ocean.fft.matmul import ifft2_matmul
    return functools.partial(ifft2_matmul, precision=precision)

"""DFT-as-matmul FFT backend: the transform written as dense matrix products.

Two formulations of the unnormalized inverse DFT along an axis:

* ``direct``    — Y = X @ Fᵀ with F[k,n] = e^{+2πi kn/N}: one big matmul,
                  O(N²) per row. Any N.
* ``four-step`` — Cooley-Tukey split N = N1·N2 (Bailey's algorithm; see
                  PAPERS.md transpose-free FFT literature):
                      view x as A[n2, n1]           (reshape)
                      B = F_{N2} @ A                (matmul)
                      C = B ⊙ T,  T[k2,n1] = e^{+2πi n1 k2/N}   (twiddle)
                      D = C @ F_{N1}ᵀ               (matmul)
                      X[k2 + N2·k1] = D[k2, k1]     (transpose + reshape)
                  O(N(N1+N2)) per row — ~N/(N1+N2)× fewer FLOPs than direct
                  while still being two dense matmuls.

Complex arithmetic is carried as explicit (re, im) float32 pairs: 4 real
matmuls per complex matmul, each under the precision policy of :func:`_dot`.
This backend is the comparison point for the library FFT (``reference``): the
same four-step math as a hand-written transform, left to XLA's matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax


def _split_n(n: int):
    """Balanced factorization n = n1·n2 with n1 ≥ n2 (powers of two split
    exactly; otherwise the largest divisor ≤ sqrt(n))."""
    n2 = int(np.sqrt(n))
    while n2 > 1 and n % n2 != 0:
        n2 -= 1
    return n // n2, n2


@functools.lru_cache(maxsize=64)
def _dft_tables(n: int, inverse: bool):
    sign = +1.0 if inverse else -1.0
    k = np.arange(n)
    f = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return f


@functools.lru_cache(maxsize=64)
def _four_step_tables(n: int, inverse: bool):
    n1, n2 = _split_n(n)
    sign = +1.0 if inverse else -1.0
    f1 = _dft_tables(n1, inverse)
    f2 = _dft_tables(n2, inverse)
    k2 = np.arange(n2)[:, None]
    n1i = np.arange(n1)[None, :]
    tw = np.exp(sign * 2j * np.pi * k2 * n1i / n)
    return n1, n2, f1, f2, tw


def _dot(eq: str, a, b, precision: str):
    """One real einsum under the precision policy.

    ``'float32'``: f32 operands at ``Precision.HIGHEST`` — full f32 products
    (the default precision may run f32 dots in TF32 on tensor cores, which
    keeps ~3 decimal digits). ``'bfloat16'``: operands cast to bf16
    explicitly, products accumulated in f32 (``preferred_element_type``)."""
    if precision == "bfloat16":
        return jnp.einsum(eq, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    if precision != "float32":
        raise ValueError(f"bad precision {precision!r}; "
                         f"use 'float32' or 'bfloat16'")
    return jnp.einsum(eq, a, b, precision=lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def _cmul_matmul(ar, ai, br, bi, precision):
    """(ar + i·ai) @ (br + i·bi) as 4 real matmuls."""
    eq = "...ij,jk->...ik"
    rr = _dot(eq, ar, br, precision) - _dot(eq, ai, bi, precision)
    ri = _dot(eq, ar, bi, precision) + _dot(eq, ai, br, precision)
    return rr, ri


def fft_matmul_1d(x: jnp.ndarray, inverse: bool = True,
                  mode: str = "four_step",
                  precision: str = "float32") -> jnp.ndarray:
    """Unnormalized (i)DFT along the LAST axis via matmuls."""
    n = x.shape[-1]
    re = jnp.real(x).astype(jnp.float32)
    im = jnp.imag(x).astype(jnp.float32)

    if mode == "direct" or n < 16 or _split_n(n)[1] == 1:
        f = _dft_tables(n, inverse)
        fr = jnp.asarray(f.real, dtype=jnp.float32)
        fi = jnp.asarray(f.imag, dtype=jnp.float32)
        # Y = X @ Fᵀ (F symmetric, so @F works; keep transpose explicit anyway)
        rr, ri = _cmul_matmul(re, im, fr.T, fi.T, precision)
        return rr + 1j * ri

    n1, n2, f1, f2, tw = _four_step_tables(n, inverse)
    batch = x.shape[:-1]
    a_re = re.reshape(batch + (n2, n1))
    a_im = im.reshape(batch + (n2, n1))

    # B = F_{N2} @ A  — contract over n2: einsum('ks,...st->...kt')
    f2r = jnp.asarray(f2.real, dtype=jnp.float32)
    f2i = jnp.asarray(f2.imag, dtype=jnp.float32)
    def lmat(mr, mi, xr, xi):
        eq = "ks,...st->...kt"
        rr = _dot(eq, mr, xr, precision) - _dot(eq, mi, xi, precision)
        ri = _dot(eq, mr, xi, precision) + _dot(eq, mi, xr, precision)
        return rr, ri
    b_re, b_im = lmat(f2r, f2i, a_re, a_im)

    # C = B ⊙ twiddle
    twr = jnp.asarray(tw.real, dtype=jnp.float32)
    twi = jnp.asarray(tw.imag, dtype=jnp.float32)
    c_re = b_re * twr - b_im * twi
    c_im = b_re * twi + b_im * twr

    # D = C @ F_{N1}ᵀ — contract over n1
    f1r = jnp.asarray(f1.real, dtype=jnp.float32)
    f1i = jnp.asarray(f1.imag, dtype=jnp.float32)
    d_re, d_im = _cmul_matmul(c_re, c_im, f1r.T, f1i.T, precision)

    # X[k2 + N2·k1] = D[k2, k1] → transpose to [k1, k2] then flatten
    d_re = jnp.swapaxes(d_re, -1, -2).reshape(batch + (n,))
    d_im = jnp.swapaxes(d_im, -1, -2).reshape(batch + (n,))
    return d_re + 1j * d_im


def ifft2_matmul(x: jnp.ndarray, mode: str = "four_step",
                 precision: str = "float32") -> jnp.ndarray:
    """Unnormalized inverse FFT over the last two axes via matmuls."""
    x = fft_matmul_1d(x, inverse=True, mode=mode, precision=precision)
    x = jnp.swapaxes(x, -1, -2)
    x = fft_matmul_1d(x, inverse=True, mode=mode, precision=precision)
    return jnp.swapaxes(x, -1, -2)


def fft2_matmul(x: jnp.ndarray, mode: str = "four_step",
                precision: str = "float32") -> jnp.ndarray:
    x = fft_matmul_1d(x, inverse=False, mode=mode, precision=precision)
    x = jnp.swapaxes(x, -1, -2)
    x = fft_matmul_1d(x, inverse=False, mode=mode, precision=precision)
    return jnp.swapaxes(x, -1, -2)

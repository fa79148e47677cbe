"""FFT backend unit tests: every backend vs numpy's FFT, and backends vs each
other inside the solver (SURVEY.md §4.4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_ocean.fft.reference import ifft2_unnorm
from tpu_ocean.fft.stockham import ifft2_stockham, fft2_stockham, fft_stockham_1d
from tpu_ocean.fft.matmul import ifft2_matmul, fft_matmul_1d


def _rand_complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_stockham_matches_numpy(n):
    rng = np.random.default_rng(0)
    x = _rand_complex(rng, (3, n, n))
    got = np.asarray(ifft2_stockham(jnp.asarray(x)))
    want = np.fft.ifft2(x) * n * n
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_stockham_forward_sign_matches_shader_twiddle():
    # GetTwiddle returns −2π·ratio (FFTCommon.cginc:116-119) ⇒ forward DFT
    rng = np.random.default_rng(1)
    x = _rand_complex(rng, (2, 64, 64))
    got = np.asarray(fft2_stockham(jnp.asarray(x)))
    want = np.fft.fft2(x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_stockham_stage_count():
    # iterations = 2·log2 N per 2-D transform (OceanRenderer.cs:231); our 1-D
    # pass runs log2 N stages — verify the network length via a size sweep
    from tpu_ocean.fft.stockham import _stage_tables
    for n in (8, 32, 1024):
        assert len(_stage_tables(n, True)) == int(np.log2(n))


@pytest.mark.parametrize("mode", ["direct", "four_step"])
@pytest.mark.parametrize("n", [64, 256])
def test_matmul_matches_numpy(mode, n):
    rng = np.random.default_rng(2)
    x = _rand_complex(rng, (3, n, n))
    got = np.asarray(ifft2_matmul(jnp.asarray(x), mode=mode))
    want = np.fft.ifft2(x) * n * n
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5


def test_matmul_non_power_of_two():
    rng = np.random.default_rng(3)
    x = _rand_complex(rng, (96,))
    got = np.asarray(fft_matmul_1d(jnp.asarray(x), inverse=True))
    want = np.fft.ifft(x) * 96
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5


def test_backends_agree_in_solver():
    """Same state through reference/stockham/matmul backends ⇒ same fields."""
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver

    n = 64
    cfg = OceanConfig(resolution=n, length=float(n), unit_width=1.0,
                      wind=(7.0, 4.0), amplitude=0.1, choppiness=1.0)
    rng = np.random.default_rng(4)
    h0 = 0.03 * _rand_complex(rng, (n, n))
    h0c = 0.03 * _rand_complex(rng, (n, n))

    outs = {}
    for backend in ("reference", "stockham", "matmul"):
        solver = OceanSolver(cfg, fft_backend=backend)
        state = solver.init(h0=h0, h0_conj=h0c)
        _, f = solver.step(state, 0.02)
        outs[backend] = np.asarray(f.height)
    scale = np.abs(outs["reference"]).max()
    for backend in ("stockham", "matmul"):
        np.testing.assert_allclose(outs[backend], outs["reference"],
                                   atol=3e-5 * scale,
                                   err_msg=f"{backend} disagrees with reference")


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_matmul_precision_policy(precision):
    """f32 dots run at Precision.HIGHEST (no reduced-precision f32 path);
    'bfloat16' casts the dot operands to bf16 explicitly and accumulates
    in f32 — never by leaning on the default precision."""
    import jax
    from tpu_ocean.fft.matmul import ifft2_matmul
    x = jnp.ones((2, 32, 32), jnp.complex64)
    jaxpr = jax.make_jaxpr(lambda a: ifft2_matmul(a, precision=precision))(x)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        ins = {v.aval.dtype for v in e.invars}
        assert e.outvars[0].aval.dtype == jnp.float32
        if precision == "float32":
            assert ins == {jnp.dtype(jnp.float32)}
            assert str(e.params["precision"]).count("HIGHEST") == 2
        else:
            assert ins == {jnp.dtype(jnp.bfloat16)}
            assert "HIGHEST" not in str(e.params["precision"])
    with pytest.raises(ValueError, match="precision"):
        ifft2_matmul(x, precision="tf32")


def test_get_ifft2_names_valid_backends():
    from tpu_ocean.fft import BACKENDS, get_ifft2
    with pytest.raises(ValueError) as e:
        get_ifft2("pallas", 32)
    assert str(BACKENDS) in str(e.value)

"""Solver ↔ oracle parity — BASELINE configs 1 and 2 (SURVEY.md §4.1).

Oracle and solver share the SAME injected h0/h0_conj (the reference RNGs are
not reproducible; SURVEY.md §7 "Two RNG regimes"). The float64 oracle is the
truth; the float32 solver must match to float32-accumulation tolerance.
"""

import numpy as np
import jax
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.oracle import Oracle, assert_fields_close
from tpu_ocean.solver import OceanSolver


def _make_case(n, length=None, seed=0, amplitude=0.05):
    length = float(n) if length is None else length
    cfg = OceanConfig(
        resolution=n, length=length, unit_width=length / n,
        wind=(8.0, 5.0), amplitude=amplitude, choppiness=1.2,
        dispersion_mode="quantized", evolution_mode="absolute",
        spectrum_layout="centered", normals_mode="spectral", seed=seed)
    rng = np.random.default_rng(seed)
    h0 = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    # scale like a physical spectrum so tolerances are meaningful
    scale = np.sqrt(Oracle(cfg)._phillips_at(
        *np.meshgrid(np.arange(n, dtype=np.float64),
                     np.arange(n, dtype=np.float64), indexing="ij")) / 2.0)
    h0 = h0 * scale
    h0c = h0c * scale
    return cfg, h0, h0c


def _assert_fields_close(got, want, rtol, atol_scale):
    """Oracle parity tolerance (tpu_ocean.oracle.assert_fields_close): atol
    proportional to each field's dynamic range, foam under the
    near-threshold rule, normals to 1e-3 absolute."""
    assert_fields_close(got, want, rtol=rtol, atol_scale=atol_scale)


@pytest.mark.parametrize("backend", ["reference"])
def test_config1_64sq_single_step(backend):
    """BASELINE config 1: 64² heightfield, one step, FFT path vs oracle."""
    cfg, h0, h0c = _make_case(64)
    oracle = Oracle(cfg, h0=h0, h0_conj=h0c)
    solver = OceanSolver(cfg, fft_backend=backend)
    state = solver.init(h0=h0, h0_conj=h0c)

    dt = 1.0 / 60.0
    state, fields = solver.step(state, dt)
    want = oracle.fields(dt)
    _assert_fields_close(fields, want, rtol=1e-4, atol_scale=2e-5)


def test_config1_direct_mode_incommensurate_length():
    """Direct (dense matmul) evaluation handles length ≠ N·unit_width — the
    FFT Mesh demo's L=12.39 over a 12² unit grid (FFT Mesh.unity:147-150)."""
    n = 12
    cfg = OceanConfig(
        resolution=n, length=12.39, unit_width=1.0, wind=(5.0, 3.0),
        amplitude=0.01, choppiness=1.0, dispersion_mode="quantized",
        evolution_mode="absolute", spectrum_layout="centered",
        normals_mode="spectral")
    rng = np.random.default_rng(5)
    h0 = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))

    oracle = Oracle(cfg, h0=h0, h0_conj=h0c)
    solver = OceanSolver(cfg, eval_mode="direct")
    state = solver.init(h0=h0, h0_conj=h0c)
    state, fields = solver.step(state, 0.1)
    want = oracle.fields(0.1)
    _assert_fields_close(fields, want, rtol=1e-4, atol_scale=2e-5)


def test_config2_256sq_100_steps():
    """BASELINE config 2: 256² full state (height + choppy displacement +
    normals + Jacobian whitecaps) after 100 steps."""
    cfg, h0, h0c = _make_case(256, amplitude=0.2)
    oracle = Oracle(cfg, h0=h0, h0_conj=h0c)
    solver = OceanSolver(cfg)
    state = solver.init(h0=h0, h0_conj=h0c)

    dt = 1.0 / 60.0
    for _ in range(100):
        state, fields = solver.step(state, dt)
    # absolute-time mode is stateless in t: oracle evaluated at 100·dt.
    want = oracle.fields(100 * dt)
    _assert_fields_close(fields, want, rtol=1e-3, atol_scale=2e-4)


def test_step_determinism():
    """Same state, same dt ⇒ bit-identical outputs (SURVEY.md §4.5)."""
    cfg, h0, h0c = _make_case(32)
    solver = OceanSolver(cfg)

    def run():
        state = solver.init(h0=h0, h0_conj=h0c)
        for _ in range(3):
            state, f = solver.step(state, 0.01)
        return jax.device_get(f.height)

    a, b = run(), run()
    assert np.array_equal(a, b)


def test_phase_mode_matches_absolute_with_constant_dt():
    """With capillary dispersion and fixed dt, accumulated phase equals ω·t
    (mod 2π wrapping is immaterial inside cos/sin)."""
    n = 32
    base = dict(resolution=n, length=float(n), unit_width=1.0,
                wind=(6.0, 2.0), amplitude=0.05, choppiness=0.8,
                dispersion_mode="capillary", spectrum_layout="centered",
                normals_mode="spectral")
    rng = np.random.default_rng(9)
    h0 = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    h0c = 0.02 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))

    abs_solver = OceanSolver(OceanConfig(evolution_mode="absolute", **base))
    ph_solver = OceanSolver(OceanConfig(evolution_mode="phase", **base))
    sa = abs_solver.init(h0=h0, h0_conj=h0c)
    sp = ph_solver.init(h0=h0, h0_conj=h0c)
    dt = 0.02
    for _ in range(10):
        sa, fa = abs_solver.step(sa, dt)
        sp, fp = ph_solver.step(sp, dt)
    np.testing.assert_allclose(np.asarray(fp.height), np.asarray(fa.height),
                               rtol=1e-3, atol=1e-4 * np.abs(fa.height).max())


def test_quantized_dispersion_exact_time_periodicity():
    """The whole point of the quantized dispersion (FFTMesh.cs:141-147):
    every ω is an integer multiple of ω₀ = 2π/L, so the ocean repeats
    EXACTLY with period T = L. fields_at(t) must equal fields_at(t + L)."""
    cfg, h0, h0c = _make_case(32)
    solver = OceanSolver(cfg)
    state = solver.init(h0=h0, h0_conj=h0c)
    t = 0.73
    a = solver.fields_at(state, t)
    b = solver.fields_at(state, t + cfg.length)
    np.testing.assert_allclose(np.asarray(b.height), np.asarray(a.height),
                               atol=2e-3 * np.abs(np.asarray(a.height)).max())


def test_capillary_dispersion_not_periodic():
    """Sanity inverse: the continuous capillary mode must NOT repeat at L."""
    cfg, h0, h0c = _make_case(32)
    cfg = cfg.replace(dispersion_mode="capillary")
    solver = OceanSolver(cfg)
    state = solver.init(h0=h0, h0_conj=h0c)
    a = solver.fields_at(state, 0.73)
    b = solver.fields_at(state, 0.73 + cfg.length)
    assert not np.allclose(np.asarray(b.height), np.asarray(a.height),
                           atol=1e-3 * np.abs(np.asarray(a.height)).max())

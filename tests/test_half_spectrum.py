"""Half-spectrum (C2R) route (fft.reference.irfft2_half, VERDICT r3 #1):
the last packed channel's spectrum is exactly Hermitian, so its transform
reads spectral rows 0..N/2 only (jnp.fft.irfft2 over the k1 axis).

Parity claims under test:
  * transform level — on ANY Hermitian spectrum, the half route equals the
    Re part of the full complex transform, for any leading batch shape;
  * solver level — OceanSolver(..., half_spectrum=True) reproduces the
    packed solver's fields to f32 rounding (which itself matches unpacked,
    test_packing).
Reference anchor: the symmetry is the one the reference's Stockham shader
packs two channels with (Stockham.shader:53-54), applied per-transform."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from test_packing import _cfg, _pair, _assert_fields_close


def _hermitian_spectrum(n, c=1, seed=0, scale=0.3):
    """Random exactly-Hermitian [C, N, N] complex spectrum (numpy f64 →
    f32 planes)."""
    rng = np.random.default_rng(seed)
    s = scale * (rng.normal(size=(c, n, n)) + 1j * rng.normal(size=(c, n, n)))
    neg = (-np.arange(n)) % n
    s = 0.5 * (s + np.conj(s[:, np.ix_(neg, neg)[0], np.ix_(neg, neg)[1]]))
    return s


@pytest.mark.parametrize("n", [64, 256, 384, 640, 1024])
@pytest.mark.parametrize("batch", [(2,), (2, 3)])
def test_half_transform_matches_full_re(n, batch):
    """ifft2_planes_half on rows 0..N/2 == Re of the full ifft2_planes
    (unnormalized: no 1/N² anywhere), any leading batch shape; N runs over
    powers of two and the non-power-of-two grids 384 and 640."""
    from tpu_ocean.fft.reference import ifft2_planes, ifft2_planes_half
    c = int(np.prod(batch))
    s = _hermitian_spectrum(n, c=c, seed=3).reshape(batch + (n, n))
    re = jnp.asarray(s.real, jnp.float32)
    im = jnp.asarray(s.imag, jnp.float32)
    fr, fi = ifft2_planes(re, im)
    m = n // 2
    half = ifft2_planes_half(re[..., :m + 1, :], im[..., :m + 1, :])
    assert half.shape == batch + (n, n)
    scale = np.abs(np.asarray(fr)).max()
    # unnormalized scale: the f64 numpy inverse times N²
    want = np.fft.ifft2(s).real * n * n
    np.testing.assert_allclose(np.asarray(fr), want, atol=2e-5 * scale)
    # full transform of a Hermitian spectrum is real: Im ≈ 0 pins the input
    assert np.abs(np.asarray(fi)).max() < 1e-4 * scale
    np.testing.assert_allclose(np.asarray(half), np.asarray(fr),
                               atol=2e-5 * scale)


def test_half_transform_validates_input():
    from tpu_ocean.fft.reference import ifft2_planes_half
    x = jnp.zeros((1, 30, 64), jnp.float32)
    with pytest.raises(ValueError, match="N/2"):
        ifft2_planes_half(x, x)


@pytest.mark.parametrize("normals,n,real", [
    ("stencil", 64, True), ("stencil", 64, False),
    ("spectral", 64, True), ("spectral", 64, False),
    ("stencil", 48, True), ("stencil", 48, False)])
def test_half_spectrum_step_matches_packed(normals, n, real):
    """Flagship-shaped parity: half_spectrum vs plain packed on the SAME
    injected h0 (one shared h0, never independent draws), for both state
    layouts (OceanStateReal planes and complex OceanState) and a grid that
    is not a power of two."""
    cfg = _cfg(n=n, normals=normals)
    h0, h0c = _pair(n)
    kw = dict(real_state=real, pack_channels=True)
    ref = OceanSolver(cfg, **kw)
    got = OceanSolver(cfg, half_spectrum=True, **kw)
    s_ref = ref.init(h0=h0, h0_conj=h0c)
    s_got = got.init(h0=h0, h0_conj=h0c)
    for _ in range(3):
        s_ref, f_ref = ref.step(s_ref, 1 / 60)
        s_got, f_got = got.step(s_got, 1 / 60)
    _assert_fields_close(f_got, f_ref, 5e-6)


def test_half_spectrum_validation():
    cfg = _cfg(n=64)
    with pytest.raises(ValueError, match="pack_channels"):
        OceanSolver(cfg, real_state=True, half_spectrum=True)
    with pytest.raises(ValueError, match="reference"):
        OceanSolver(cfg, fft_backend="matmul", pack_channels=True,
                    half_spectrum=True)
    with pytest.raises(ValueError, match="even"):
        OceanSolver(_cfg(n=25), real_state=True, pack_channels=True,
                    half_spectrum=True)


def test_half_spectrum_simulation_passthrough(tmp_path):
    """Simulation(**solver_kw) carries the switch; checkpoint/resume keeps
    the trajectory bitwise (same wire format — no new state)."""
    from tpu_ocean.runtime import Simulation
    cfg = _cfg(n=64)
    kw = dict(real_state=True, pack_channels=True, half_spectrum=True)
    sim = Simulation(cfg, out_dir=str(tmp_path), checkpoint_every=2, **kw)
    assert sim.solver.half_spectrum
    sim.run(2)
    sim.close()
    sim2 = Simulation(cfg, out_dir=str(tmp_path), checkpoint_every=2, **kw)
    assert sim2.step_count == 2
    f_a = sim.step()
    f_b = sim2.step()
    np.testing.assert_array_equal(np.asarray(f_a.height),
                                  np.asarray(f_b.height))
    sim2.close()


@pytest.mark.parametrize("normals", ["stencil", "spectral"])
@pytest.mark.parametrize("real", [True, False])
def test_half_spectrum_cascade_matches_packed(normals, real):
    """CascadeSolver(half_spectrum=True): every band's last packed channel
    rides ONE batched C2R transform over the band axis (B triples on B×1.5
    transform-equivalents) — fields match the plain packed cascade on the
    same seeded draw (bit-identical init, cascade.py real-state contract)."""
    import dataclasses
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = [dataclasses.replace(c, normals_mode=normals)
            for c in default_cascade(n=64, lengths=(100.0, 13.0))]
    kw = dict(real_state=real, pack_channels=True)
    ref = CascadeSolver(cfgs, **kw)
    got = CascadeSolver(cfgs, half_spectrum=True, **kw)
    key = jax.random.PRNGKey(11)
    s_ref, s_got = ref.init(key), got.init(key)
    np.testing.assert_array_equal(np.asarray(s_ref[0]), np.asarray(s_got[0]))
    for _ in range(3):
        s_ref, f_ref = ref.step(s_ref, 1 / 60)
        s_got, f_got = got.step(s_got, 1 / 60)
    _assert_fields_close(f_got, f_ref, 5e-6)


def test_half_spectrum_lod_cascade_and_reconfigure():
    """LODCascadeSolver threads the switch into its inner cascade (the
    subset refresh path reuses _real_planes, so LOD frames ride the C2R
    fold too); structural reconfigure PRESERVES the switch."""
    import dataclasses
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.lod import LODCascadeSolver
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    kw = dict(real_state=True, pack_channels=True, half_spectrum=True)
    ref = LODCascadeSolver(cfgs, periods=(1, 2), **kw)
    plain = LODCascadeSolver(cfgs, periods=(1, 2), real_state=True,
                             pack_channels=True)
    assert ref.inner.half_spectrum
    s_a, s_b = ref.init(jax.random.PRNGKey(3)), plain.init(
        jax.random.PRNGKey(3))
    for _ in range(3):
        s_a, f_a = ref.step(s_a)
        s_b, f_b = plain.step(s_b)
    _assert_fields_close(f_a, f_b, 5e-6)
    # structural rebuild (choppiness is NOT init-only) keeps half_spectrum
    flat = CascadeSolver(cfgs, **kw)
    st = flat.init(jax.random.PRNGKey(3))
    new_cfgs = [dataclasses.replace(c, choppiness=0.9) for c in cfgs]
    solver2, _ = flat.reconfigure(st, new_cfgs)
    assert solver2.half_spectrum


def test_half_spectrum_cascade_validation():
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    with pytest.raises(ValueError, match="pack_channels"):
        CascadeSolver(cfgs, real_state=True, half_spectrum=True)
    with pytest.raises(ValueError, match="reference"):
        CascadeSolver(cfgs, fft_backend="matmul", pack_channels=True,
                      half_spectrum=True)
    bad = default_cascade(n=25, lengths=(100.0,))
    with pytest.raises(ValueError, match="even"):
        CascadeSolver(bad, real_state=True, pack_channels=True,
                      half_spectrum=True)


def test_half_spectrum_cascade_simulation_passthrough(tmp_path):
    """CascadeSimulation carries the switch to both the flat and the LOD
    solver; checkpoint/resume keeps the trajectory bitwise."""
    from tpu_ocean.cascade import default_cascade
    from tpu_ocean.runtime import CascadeSimulation
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    kw = dict(real_state=True, pack_channels=True, half_spectrum=True)
    sim = CascadeSimulation(cfgs, out_dir=str(tmp_path),
                            checkpoint_every=2, **kw)
    assert sim.solver.half_spectrum
    sim.run(2)
    sim.close()
    sim2 = CascadeSimulation(cfgs, out_dir=str(tmp_path),
                             checkpoint_every=2, **kw)
    f_a = sim.step()
    f_b = sim2.step()
    np.testing.assert_array_equal(np.asarray(f_a.height),
                                  np.asarray(f_b.height))
    sim2.close()
    lod = CascadeSimulation(cfgs, camera_distance=300.0, **kw)
    assert lod.solver.inner.half_spectrum
    f = lod.step()
    assert np.isfinite(np.asarray(f.height)).all()
    lod.close()


def test_half_spectrum_velocity_matches_packed():
    """velocity() under half_spectrum rides the C2R transform (v̂ is
    exactly Hermitian under the packed projection — the same symmetry as
    the height channel); values match the packed solver's velocity."""
    cfg = _cfg(n=64)
    h0, h0c = _pair(64)
    kw = dict(real_state=True, pack_channels=True)
    ref = OceanSolver(cfg, **kw)
    got = OceanSolver(cfg, half_spectrum=True, **kw)
    s_ref = ref.init(h0=h0, h0_conj=h0c)
    s_got = got.init(h0=h0, h0_conj=h0c)
    s_ref, _ = ref.step(s_ref, 1 / 60)
    s_got, _ = got.step(s_got, 1 / 60)
    v_ref = np.asarray(ref.velocity(s_ref))
    v_got = np.asarray(got.velocity(s_got))
    scale = max(np.abs(v_ref).max(), 1e-6)
    assert np.abs(v_got - v_ref).max() < 5e-6 * scale


def test_half_spectrum_cascade_velocity_matches_packed():
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    kw = dict(real_state=True, pack_channels=True)
    ref = CascadeSolver(cfgs, **kw)
    got = CascadeSolver(cfgs, half_spectrum=True, **kw)
    key = jax.random.PRNGKey(4)
    s_ref, s_got = ref.init(key), got.init(key)
    s_ref, _ = ref.step(s_ref, 1 / 60)
    s_got, _ = got.step(s_got, 1 / 60)
    v_ref = np.asarray(ref.velocity(s_ref))
    v_got = np.asarray(got.velocity(s_got))
    scale = max(np.abs(v_ref).max(), 1e-6)
    assert np.abs(v_got - v_ref).max() < 5e-6 * scale

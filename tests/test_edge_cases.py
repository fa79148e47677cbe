"""Edge cases and degenerate configurations."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.spectra import phillips
from tpu_ocean import grids


def test_zero_amplitude_gives_flat_ocean():
    cfg = OceanConfig(resolution=32, length=32.0, wind=(6.0, 4.0),
                      amplitude=0.0, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    s = OceanSolver(cfg)
    st = s.init(jax.random.PRNGKey(0))
    st, f = s.step(st, 1 / 60)
    assert float(jnp.max(jnp.abs(f.height))) == 0.0
    np.testing.assert_allclose(np.asarray(f.normal[..., 1]), 1.0)
    # Jacobian of an undisplaced sheet is exactly 1
    np.testing.assert_allclose(np.asarray(f.jacobian), 1.0)


def test_non_power_of_two_reference_backend():
    cfg = OceanConfig(resolution=12, length=12.39, wind=(5.0, 3.0),
                      amplitude=0.01)
    s = OceanSolver(cfg, eval_mode="direct")
    st = s.init(jax.random.PRNGKey(1))
    st, f = s.step(st, 1 / 60)
    assert np.all(np.isfinite(np.asarray(f.height)))


def test_power_of_two_required_by_fast_backends():
    cfg = OceanConfig(resolution=24, length=24.0, wind=(5.0, 3.0),
                      amplitude=0.01, spectrum_layout="fft",
                      evolution_mode="phase", dispersion_mode="capillary",
                      normals_mode="stencil")
    with pytest.raises(AssertionError):
        s = OceanSolver(cfg, fft_backend="stockham")
        st = s.init(jax.random.PRNGKey(0))
        s.step(st, 1 / 60)


def test_phillips_zero_at_k_zero_and_below_cutoff():
    p = phillips(np.zeros((3, 3)), np.zeros((3, 3)), 1.0, (5.0, 3.0), 0.001)
    np.testing.assert_array_equal(np.asarray(p), 0.0)


def test_phillips_downwind_anisotropy():
    """Energy concentrates along the wind direction (k̂·ŵ)²."""
    k = 2 * np.pi / 50.0
    along = phillips(np.asarray([[k]]), np.asarray([[0.0]]), 1.0,
                     (10.0, 0.0), 0.001)
    across = phillips(np.asarray([[0.0]]), np.asarray([[k]]), 1.0,
                      (10.0, 0.0), 0.001)
    assert float(np.asarray(along)) > 100 * max(float(np.asarray(across)), 1e-300)


def test_incommensurate_length_rejected_by_fft_centered():
    cfg = OceanConfig(resolution=16, length=20.0, unit_width=1.0,
                      wind=(5.0, 3.0), amplitude=0.01,
                      spectrum_layout="centered")
    with pytest.raises(ValueError, match="length == resolution"):
        OceanSolver(cfg, eval_mode="fft")


def test_large_dt_phase_stays_bounded():
    cfg = OceanConfig(resolution=16, length=16.0, wind=(6.0, 4.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    s = OceanSolver(cfg)
    st = s.init(jax.random.PRNGKey(0))
    for _ in range(3):
        st, f = s.step(st, 1000.0)   # huge dt: φ must stay in [0, 2π)
    ph = np.asarray(st.phase)
    assert ph.min() >= 0.0 and ph.max() < 2 * np.pi + 1e-5
    assert np.all(np.isfinite(np.asarray(f.height)))


def test_even_odd_coordinate_offsets():
    even = grids.coordinate_1d(4, 1.0)
    odd = grids.coordinate_1d(5, 1.0)
    # even N: half-cell offset (FFTMesh.cs:111); odd N: integer offsets
    np.testing.assert_allclose(even, [-1.5, -0.5, 0.5, 1.5])
    np.testing.assert_allclose(odd, [-2.0, -1.0, 0.0, 1.0, 2.0])


def test_gpu_hash_seeds_requires_fft_layout():
    import pytest
    cfg = OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                      amplitude=0.1)   # centered default
    s = OceanSolver(cfg)
    with pytest.raises(ValueError, match="fft"):
        s.init(gpu_hash_seeds=(0.3, 0.8))


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "fft"])
def test_unknown_fft_backend_names_the_valid_ones(backend):
    """Backends that no longer exist (the removed Pallas kernels) or never
    did fail at construction with the list of valid backends."""
    from tpu_ocean.fft import BACKENDS
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    cfg = OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                      amplitude=0.1, spectrum_layout="fft",
                      normals_mode="stencil")
    for build in (lambda: OceanSolver(cfg, fft_backend=backend),
                  lambda: DistributedOceanSolver(cfg, make_mesh(shard=2),
                                                 fft_backend=backend)):
        with pytest.raises(ValueError) as e:
            build()
        assert str(BACKENDS) in str(e.value)


def test_distributed_jonswap_matches_single():
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    cfg = OceanConfig(resolution=64, length=500.0, wind=(12.0, 0.0),
                      amplitude=1.0, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil", spectrum_model="jonswap")
    key = jax.random.PRNGKey(0)
    single = OceanSolver(cfg)
    dist = DistributedOceanSolver(cfg, make_mesh(shard=8))
    s1, f1 = single.step(single.init(key), 1 / 60)
    s2, f2 = dist.step(dist.init(key), 1 / 60)
    np.testing.assert_allclose(np.asarray(f2.height), np.asarray(f1.height),
                               atol=1e-4 * np.abs(np.asarray(f1.height)).max())


def test_shipping_switches_at_any_even_resolution():
    """The shipping switch set (solver.PRODUCTION) has only the math's
    constraint — an even N for the N/2+1-row C2R input — so grids the old
    hand kernels refused (N % 16, N < 64) build, step, and match the
    unpacked full-transform step."""
    from tpu_ocean.solver import PRODUCTION
    for n in (24, 40, 96):
        cfg = OceanConfig(resolution=n, length=float(n), wind=(8.0, 5.0),
                          amplitude=0.4, spectrum_layout="fft",
                          normals_mode="stencil", evolution_mode="phase",
                          dispersion_mode="capillary")
        ship = OceanSolver(cfg, **PRODUCTION)
        full = OceanSolver(cfg, real_state=True, pack_channels=True)
        key = jax.random.PRNGKey(3)
        _, f1 = ship.step(ship.init(key), 1 / 60)
        _, f2 = full.step(full.init(key), 1 / 60)
        h = np.asarray(f2.height)
        np.testing.assert_allclose(np.asarray(f1.height), h,
                                   atol=5e-6 * np.abs(h).max())


def test_fields_at_refuses_phase_mode():
    """fields_at evaluates the stateless ω·t form; in phase mode that
    silently disagrees with the accumulated per-mode phase — it must
    refuse like velocity() does (review finding, r5)."""
    import jax
    import pytest
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver
    cfg = OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    s = OceanSolver(cfg)
    st = s.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="absolute"):
        s.fields_at(st, 1.0)
    # absolute mode keeps working
    s2 = OceanSolver(cfg.replace(evolution_mode="absolute",
                                 dispersion_mode="quantized"))
    st2 = s2.init(jax.random.PRNGKey(0))
    f = s2.fields_at(st2, 1.0)
    assert f.height.shape == (16, 16)

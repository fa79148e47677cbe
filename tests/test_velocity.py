"""OceanSolver.velocity — the analytic ∂h/∂t must match finite differences
of the height trajectory itself, in both evolution modes and for every state
representation (complex / real-plane / packed)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver


def _cfg(mode):
    return OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0),
                       amplitude=0.3, evolution_mode=mode,
                       dispersion_mode="capillary", spectrum_layout="fft",
                       normals_mode="stencil")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_velocity_matches_fd_absolute_mode():
    solver = OceanSolver(_cfg("absolute"), fft_backend="matmul")
    state = solver.init(jax.random.PRNGKey(0))
    t, eps = 2.0, 5e-3
    v = np.asarray(solver.velocity(state, t))
    hp = np.asarray(solver.fields_at(state, t + eps).height)
    hm = np.asarray(solver.fields_at(state, t - eps).height)
    fd = (hp - hm) / (2 * eps)
    assert np.isfinite(v).all() and np.abs(v).max() > 0
    assert _rel_l2(v, fd) < 2e-2      # fp32 FD cancellation sets the floor


def test_velocity_matches_fd_phase_mode():
    solver = OceanSolver(_cfg("phase"), fft_backend="reference")
    state = solver.init(jax.random.PRNGKey(1))
    dt = 1.0 / 60.0
    for _ in range(3):
        state, _ = solver.step(state, dt)
    v = np.asarray(solver.velocity(state))
    # step() evaluates fields at the UPDATED phase, so stepping ±dt yields
    # the heights surrounding this state's phase (accumulation reverses);
    # step donates its input, so each probe gets its own copy
    _, f_prev = solver.step(jax.tree.map(jnp.copy, state), -dt)
    _, f_next = solver.step(jax.tree.map(jnp.copy, state), dt)
    fd = (np.asarray(f_next.height) - np.asarray(f_prev.height)) / (2 * dt)
    assert _rel_l2(v, fd) < 2e-2
    with pytest.raises(ValueError, match="phase mode"):
        solver.velocity(state, t=1.0)


def test_velocity_honors_dt_multiplier_phase_mode():
    """Phase mode advances φ by ω·dt·dt_multiplier per wall dt (the OCEAN
    preset uses 1.5) — the reported ∂h/∂t must carry that factor or every
    consumer is systematically slow."""
    solver = OceanSolver(_cfg("phase").replace(dt_multiplier=1.5),
                         fft_backend="reference")
    state = solver.init(jax.random.PRNGKey(3))
    dt = 1.0 / 60.0
    for _ in range(2):
        state, _ = solver.step(state, dt)
    v = np.asarray(solver.velocity(state))
    _, f_prev = solver.step(jax.tree.map(jnp.copy, state), -dt)
    _, f_next = solver.step(jax.tree.map(jnp.copy, state), dt)
    fd = (np.asarray(f_next.height) - np.asarray(f_prev.height)) / (2 * dt)
    assert _rel_l2(v, fd) < 2e-2


def test_velocity_direct_mode():
    """eval_mode='direct' (the oracle-convention dense DFT) must also report
    velocity — it rides the same generic transform."""
    cfg = OceanConfig(resolution=32, length=40.0, unit_width=1.0,
                      wind=(8.0, 5.0), amplitude=0.3,
                      evolution_mode="absolute", dispersion_mode="quantized",
                      spectrum_layout="centered", normals_mode="spectral")
    solver = OceanSolver(cfg, eval_mode="direct")
    state = solver.init(jax.random.PRNGKey(4))
    t, eps = 1.0, 5e-3
    v = np.asarray(solver.velocity(state, t))
    hp = np.asarray(solver.fields_at(state, t + eps).height)
    hm = np.asarray(solver.fields_at(state, t - eps).height)
    assert _rel_l2(v, (hp - hm) / (2 * eps)) < 2e-2


@pytest.mark.parametrize("kw", [
    dict(real_state=True),
    dict(real_state=True, pack_channels=True, half_spectrum=True),
    dict(fft_backend="matmul"),
])
def test_velocity_consistent_across_representations(kw):
    """Real-plane, packed + half-spectrum, and matmul-backend solvers report
    the same velocity as the plain complex path (same injected h0)."""
    cfg = _cfg("phase")
    ref = OceanSolver(cfg, fft_backend="reference")
    other = OceanSolver(cfg, **kw)
    s_ref = ref.init(jax.random.PRNGKey(2))
    s_oth = other.init(jax.random.PRNGKey(2))
    dt = 1.0 / 60.0
    for _ in range(2):
        s_ref, _ = ref.step(s_ref, dt)
        s_oth, _ = other.step(s_oth, dt)
    v_ref = np.asarray(ref.velocity(s_ref))
    v_oth = np.asarray(other.velocity(s_oth))
    scale = np.abs(v_ref).max()
    assert np.abs(v_ref - v_oth).max() < 2e-3 * scale


def test_cascade_velocity_matches_band_sum_and_fd():
    """Cascade velocity = Σ per-band OceanSolver velocities (same phases),
    and tracks the finite difference of the combined height trajectory."""
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    solver = CascadeSolver(cfgs, real_state=True)
    st = solver.init(jax.random.PRNGKey(2))
    dt = 1.0 / 60.0
    for _ in range(2):
        st, _ = solver.step(st, dt)
    v = np.asarray(solver.velocity(st))
    _, f_prev = solver.step(jax.tree.map(jnp.copy, st), -dt)
    _, f_next = solver.step(jax.tree.map(jnp.copy, st), dt)
    fd = (np.asarray(f_next.height) - np.asarray(f_prev.height)) / (2 * dt)
    assert _rel_l2(v, fd) < 2e-2


def test_velocity_real_state_is_f32_and_cached():
    """The real-state velocity path must (a) take f32 planes and return an
    f32 plane (no complex array crosses its boundary), and (b) cache its
    jitted callable so serve.FrameServer pays one trace per stream, not per
    frame (ADVICE r2 medium)."""
    solver = OceanSolver(_cfg("phase"), real_state=True)
    state = solver.init(jax.random.PRNGKey(5))
    state, _ = solver.step(state, 1.0 / 60.0)
    assert solver._velocity_real_jit is None      # lazy until first use
    v1 = solver.velocity(state)
    fn = solver._velocity_real_jit
    assert fn is not None
    v2 = solver.velocity(state)
    assert solver._velocity_real_jit is fn        # reused, not re-jitted
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    jaxpr = jax.make_jaxpr(solver._velocity_real_impl)(
        state, state.t, solver._consts["omega"])
    for v in jaxpr.in_avals + jaxpr.out_avals:
        assert v.dtype in (jnp.float32, jnp.int32), v


def test_cascade_velocity_real_state_f32():
    """Banded twin of the above: CascadeStateReal velocity takes and
    returns f32 only."""
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    solver = CascadeSolver(cfgs, real_state=True)
    st = solver.init(jax.random.PRNGKey(6))
    st, _ = solver.step(st, 1.0 / 60.0)
    v = np.asarray(solver.velocity(st))
    assert np.isfinite(v).all() and np.abs(v).max() > 0
    from functools import partial
    jaxpr = jax.make_jaxpr(partial(solver._velocity_real_impl, False))(
        st, st.t, solver._omega)
    for a in jaxpr.in_avals + jaxpr.out_avals:
        assert a.dtype in (jnp.float32, jnp.int32), a
    # complex twin agrees (same injected state content)
    from tpu_ocean.cascade import CascadeState
    cst = CascadeState(h0=st.h0_re + 1j * st.h0_im,
                       h0_conj=st.h0c_re + 1j * st.h0c_im,
                       phase=st.phase, t=st.t, step=st.step)
    v_c = np.asarray(solver._velocity_complex(cst, st.t, held_phase=False))
    assert np.abs(v - v_c).max() < 2e-3 * max(np.abs(v_c).max(), 1e-9)


def test_lod_velocity_absolute_mode_uses_refresh_phase():
    """Absolute mode: a held band's velocity must be evaluated at its
    LAST-REFRESH phase (what its displayed planes show), not the current
    clock (ADVICE r2 low). The substep caches the refresh phase in
    cascade.phase; velocity reads it via velocity_at_held_phase."""
    from tpu_ocean.lod import LODCascadeSolver
    from tpu_ocean.cascade import default_cascade
    cfgs = [c.replace(evolution_mode="absolute")
            for c in default_cascade(n=32, lengths=(100.0, 13.0))]
    dt = 1.0 / 60.0
    lod = LODCascadeSolver(cfgs, periods=[2, 1], dt=dt,
                           fft_backend="reference")
    st = lod.init(jax.random.PRNGKey(7))
    st, _ = lod.step(st)                      # frame 1: band 1 only
    ph = np.asarray(st.cascade.phase)
    om = np.asarray(lod.inner._omega)
    t1 = float(np.asarray(st.cascade.t))
    np.testing.assert_array_equal(ph[0], np.zeros_like(ph[0]))  # held at t=0
    np.testing.assert_allclose(ph[1], om[1] * np.float32(t1), rtol=1e-6)
    v = np.asarray(lod.velocity(st))
    # expected: each band at ITS refresh phase (band 0 at t=0, band 1 at t1)
    from tpu_ocean.cascade import CascadeState
    h0, h0c = st.cascade.h0, st.cascade.h0_conj
    pv = np.exp(1j * ph)
    vspec = 1j * om * (np.asarray(h0) * pv - np.asarray(h0c) * np.conj(pv))
    n = cfgs[0].resolution
    expected = np.sum(np.real(np.fft.ifft2(vspec)) * (n * n), axis=0)
    assert _rel_l2(v, expected) < 1e-4
    # and it DIFFERS from the clock-phase evaluation (the pre-fix behavior)
    v_clock = np.asarray(lod.inner.velocity(st.cascade))
    assert _rel_l2(v, v_clock) > 1e-3


def test_lod_velocity_is_displayed_surface_rate():
    """LOD velocity uses each band's LAST-REFRESH phase — finite differences
    of the DISPLAYED height across a refresh frame of every band match."""
    from tpu_ocean.lod import LODCascadeSolver
    from tpu_ocean.cascade import default_cascade
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    lod = LODCascadeSolver(cfgs, periods=[2, 1], dt=1.0 / 60.0,
                           real_state=True)
    st = lod.init(jax.random.PRNGKey(3))
    st, _ = lod.step(st)
    v = np.asarray(lod.velocity(st))
    assert np.isfinite(v).all() and np.abs(v).max() > 0
    # band 1 (period 1) refreshed at this frame: its velocity equals the
    # plain cascade's at the same state phase — delegate identity
    v_inner = np.asarray(lod.inner.velocity(st.cascade))
    np.testing.assert_array_equal(v, v_inner)


# ------------------------------------------------- pond family (VERDICT r3 #7)

@pytest.mark.parametrize("mode", ["gerstner", "wave"])
def test_pond_velocity_matches_fd(mode):
    """PondSolver.velocity (gerstner_velocity / sinusoid_velocity): the
    closed-form ∂h/∂t matches a central finite difference of the bank's own
    height output."""
    from tpu_ocean.config import PondConfig
    from tpu_ocean.gerstner import PondSolver
    cfg = PondConfig(resolution=64, displacement_mode=mode)
    solver = PondSolver(cfg)
    t, eps = 1.7, 1e-3
    v = np.asarray(solver.velocity(t))
    hp = np.asarray(solver.fields(t + eps).offset_y)
    hm = np.asarray(solver.fields(t - eps).offset_y)
    fd = (hp - hm) / (2 * eps)
    assert _rel_l2(v, fd) < 1e-3
    assert np.abs(v).max() > 0


def test_pond_velocity_off_mode_is_zero():
    from tpu_ocean.config import PondConfig
    from tpu_ocean.gerstner import PondSolver
    cfg = PondConfig(resolution=32, displacement_mode="off")
    assert np.abs(np.asarray(PondSolver(cfg).velocity(2.0))).max() == 0.0


def test_pond_simulation_state_is_clock():
    """PondSimulation.state is the sim clock — what solver.velocity consumes
    on the serving path (runtime.PondSimulation docstring)."""
    from tpu_ocean.config import PondConfig
    from tpu_ocean.runtime import PondSimulation
    sim = PondSimulation(PondConfig(resolution=32), dt=0.25)
    sim.run(3)
    assert sim.state == pytest.approx(0.75)
    v_sim = np.asarray(sim.solver.velocity(sim.state))
    v_ref = np.asarray(sim.solver.velocity(0.75))
    np.testing.assert_array_equal(v_sim, v_ref)
    # fields carry the serving aliases (height == offset_y)
    np.testing.assert_array_equal(np.asarray(sim.fields.height),
                                  np.asarray(sim.fields.offset_y))

"""Multi-band cascade solver (D7): combined fields equal the sum of the
individual band solvers, and the 'expert'-sharded step matches unsharded."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from tpu_ocean.cascade import CascadeSolver, CascadeState, default_cascade
from tpu_ocean.solver import OceanSolver
from tpu_ocean.config import OceanConfig


def test_cascade_equals_sum_of_bands():
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    casc = CascadeSolver(cfgs)
    key = jax.random.PRNGKey(4)
    state = casc.init(key)
    state, combined = casc.step(state, 1 / 60)

    keys = jax.random.split(key, 2)
    height = np.zeros((32, 32))
    disp_x = np.zeros((32, 32))
    for cfg, k in zip(cfgs, keys):
        s = OceanSolver(cfg)
        st = s.init(key=None, h0=None)
        # re-derive the same h0 the cascade drew for this band
        from tpu_ocean.spectra import h0_pair_fft
        h0, h0c = h0_pair_fft(k, cfg.resolution, cfg.length,
                              cfg.phillips_amplitude, cfg.wind, cfg.damping)
        st = s.init(h0=h0, h0_conj=h0c)
        st, f = s.step(st, 1 / 60)
        height += np.asarray(f.height)
        disp_x += cfg.choppiness * np.asarray(f.disp_x)

    np.testing.assert_allclose(np.asarray(combined.height), height, atol=1e-4)
    np.testing.assert_allclose(np.asarray(combined.disp_x), disp_x, atol=1e-4)


def test_cascade_expert_sharding_matches_unsharded():
    cfgs = default_cascade(n=32, lengths=(200.0, 50.0, 12.0, 3.0))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("expert",))
    plain = CascadeSolver(cfgs)
    sharded = CascadeSolver(cfgs, mesh=mesh)
    key = jax.random.PRNGKey(7)
    s1 = plain.init(key)
    s2 = sharded.init(key)
    for _ in range(2):
        s1, f1 = plain.step(s1, 1 / 60)
        s2, f2 = sharded.step(s2, 1 / 60)
    np.testing.assert_allclose(np.asarray(f2.height), np.asarray(f1.height),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(f2.foam), np.asarray(f1.foam),
                               atol=1e-5)


def test_cascade_validation():
    cfgs = default_cascade(n=32)
    bad = cfgs[:1] + [cfgs[1].replace(resolution=64)]
    with pytest.raises(ValueError):
        CascadeSolver(bad)
    with pytest.raises(ValueError):
        CascadeSolver([cfgs[0].replace(spectrum_layout="centered")])


def test_cascade_honors_spectrum_model():
    cfgs = [c.replace(spectrum_model="jonswap", length=500.0,
                      wind=(12.0, 0.0), amplitude=1.0, amplitude_scale=1.0)
            for c in default_cascade(n=32, lengths=(500.0, 100.0))]
    phill = [c.replace(spectrum_model="phillips") for c in cfgs]
    key = jax.random.PRNGKey(2)
    a = CascadeSolver(cfgs).init(key)
    b = CascadeSolver(phill).init(key)
    # same key, different spectrum model ⇒ different h0 magnitudes
    assert not np.allclose(np.abs(np.asarray(a.h0)),
                           np.abs(np.asarray(b.h0)))


def test_cascade_live_channel_cut_is_real():
    """Stencil-mode cascades transform B×3 channels (slopes are dead);
    spectral-mode keeps B×5. Packed: B×2 / B×3."""
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))    # stencil preset
    assert CascadeSolver(cfgs)._coeffs.shape[1] == 3
    assert CascadeSolver(cfgs, pack_channels=True)._coeffs.shape[1] == 2 * 2
    spec = [c.replace(normals_mode="spectral") for c in cfgs]
    assert CascadeSolver(spec)._coeffs.shape[1] == 5
    assert CascadeSolver(spec, pack_channels=True)._coeffs.shape[1] == 2 * 3


@pytest.mark.parametrize("normals", ["stencil", "spectral"])
def test_packed_cascade_matches_unpacked_on_hermitized_state(normals):
    """Same hermitized per-band h0 into packed and unpacked cascades →
    combined fields equal to f32 rounding (the OceanSolver packing parity
    claim, lifted over the band axis)."""
    from tpu_ocean.evolve import hermitize_pair
    cfgs = [c.replace(normals_mode=normals)
            for c in default_cascade(n=64, lengths=(100.0, 13.0))]
    key = jax.random.PRNGKey(7)

    plain = CascadeSolver(cfgs)
    packed = CascadeSolver(cfgs, pack_channels=True)
    sp = plain.init(key)
    # align starts: project the unpacked state like packed.init did
    a, ac = jax.vmap(hermitize_pair)(sp.h0, sp.h0_conj)
    sp = sp._replace(h0=a, h0_conj=ac)
    sq = packed.init(key)

    for _ in range(3):
        sp, fp = plain.step(sp, 1 / 60)
        sq, fq = packed.step(sq, 1 / 60)
    for name in ("height", "disp_x", "disp_z", "normal", "foam"):
        p = np.asarray(getattr(fp, name))
        q = np.asarray(getattr(fq, name))
        scale = max(np.abs(p).max(), 1e-6)
        assert np.abs(p - q).max() < 5e-6 * scale, name


def test_cascade_simulation_pack_threading(tmp_path):
    """CascadeSimulation forwards pack_channels; resume from an UNPACKED
    checkpoint hermitizes the state (symmetrize on restore); LOD composes
    with packing (the plane cache is extraction-side)."""
    from tpu_ocean.runtime import CascadeSimulation
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    out = str(tmp_path / "run")

    sim1 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2)
    for _ in range(2):
        sim1.step()
    sim1.close()

    sim2 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2,
                             pack_channels=True)
    assert sim2.solver.pack_channels
    assert sim2.step_count == 2
    # the restored state went through the Hermitian projection
    from tpu_ocean.evolve import hermitize_pair
    a, _ = jax.vmap(hermitize_pair)(sim2.state.h0, sim2.state.h0_conj)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(sim2.state.h0))
    sim2.step()
    sim2.close()

    # LOD composes with packing too (refreshes transform B×2 channels; the
    # plane cache stores the extracted live planes either way)
    lod = CascadeSimulation(cfgs, camera_distance=300.0, pack_channels=True)
    assert lod.solver.inner.pack_channels
    f = lod.step()
    assert np.isfinite(np.asarray(f.height)).all()


@pytest.mark.parametrize("pack", [False, True])
def test_real_state_cascade_matches_complex(pack):
    """CascadeSolver(real_state=True): the all-f32 banded step (bit-identical
    plane draw + plane transform) reproduces the complex step — the cascade
    analogue of OceanSolver's real_state contract."""
    from tpu_ocean.cascade import CascadeStateReal
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    cplx = CascadeSolver(cfgs, pack_channels=pack)
    real = CascadeSolver(cfgs, pack_channels=pack, real_state=True)
    key = jax.random.PRNGKey(5)
    sc, sr = cplx.init(key), real.init(key)
    assert isinstance(sr, CascadeStateReal)
    np.testing.assert_array_equal(np.asarray(jax.numpy.real(sc.h0)),
                                  np.asarray(sr.h0_re))   # bit-identical draw
    for _ in range(3):
        sc, fc = cplx.step(sc, 1 / 60)
        sr, fr = real.step(sr, 1 / 60)
    for name in ("height", "disp_x", "disp_z", "normal", "foam"):
        p, q = np.asarray(getattr(fc, name)), np.asarray(getattr(fr, name))
        assert np.abs(p - q).max() < 2e-5 * max(np.abs(p).max(), 1e-6), name
    # real_state hermitize is idempotent (checkpoint-resume contract)
    sym = real.symmetrize(sr)
    if pack:
        np.testing.assert_array_equal(np.asarray(sym.h0_re),
                                      np.asarray(sr.h0_re))


def test_real_state_cascade_requires_reference():
    with pytest.raises(ValueError, match="reference"):
        CascadeSolver(default_cascade(n=32), fft_backend="matmul",
                      real_state=True)
    with pytest.raises(ValueError, match="unknown fft backend"):
        CascadeSolver(default_cascade(n=32), fft_backend="pallas")


def test_cascade_simulation_real_state_resume(tmp_path):
    """CascadeSimulation(real_state=True): checkpoint and resume carry f32
    plane pairs and the trajectory continues bitwise — plain and LOD modes
    both."""
    from tpu_ocean.runtime import CascadeSimulation
    from tpu_ocean.cascade import CascadeStateReal
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    kw = dict(real_state=True, pack_channels=True)

    out = str(tmp_path / "plain")
    sim1 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2, **kw)
    for _ in range(2):
        sim1.step()
    sim1.close()

    ref = CascadeSimulation(cfgs, **kw)
    for _ in range(4):
        f_ref = ref.step()

    sim2 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2, **kw)
    assert isinstance(sim2.state, CascadeStateReal)
    assert sim2.step_count == 2
    for _ in range(2):
        f2 = sim2.step()
    sim2.close()
    np.testing.assert_array_equal(np.asarray(f2.height),
                                  np.asarray(f_ref.height))

    # LOD mode round-trips its real cascade + plane cache too
    out2 = str(tmp_path / "lod")
    lod1 = CascadeSimulation(cfgs, out_dir=out2, checkpoint_every=2,
                             periods=[2, 1], **kw)
    for _ in range(2):
        lod1.step()
    lod1.close()
    lod2 = CascadeSimulation(cfgs, out_dir=out2, checkpoint_every=2,
                             periods=[2, 1], **kw)
    assert isinstance(lod2.state.cascade, CascadeStateReal)
    assert lod2.step_count == 2
    f = lod2.step()
    assert np.isfinite(np.asarray(f.height)).all()


@pytest.mark.parametrize("backend", ["matmul", "stockham"])
def test_cascade_backend_matches_reference(backend):
    """The banded batch transforms the same on every FFT backend: the
    cascade's [B, C, N, N] spectra through matmul / stockham == jnp.fft."""
    cfgs = default_cascade(n=64, lengths=(100.0, 13.0))
    ref = CascadeSolver(cfgs)
    other = CascadeSolver(cfgs, fft_backend=backend)
    key = jax.random.PRNGKey(8)
    sp, sq = ref.init(key), other.init(key)
    for _ in range(2):
        sp, fp = ref.step(sp, 1 / 60)
        sq, fq = other.step(sq, 1 / 60)
    for name in ("height", "normal", "foam", "jacobian"):
        p, q = np.asarray(getattr(fp, name)), np.asarray(getattr(fq, name))
        assert np.abs(p - q).max() < 1e-4 * max(np.abs(p).max(), 1e-6), name


def test_real_state_cascade_expert_sharding():
    """mesh + real_state: init pre-places the plane state band-sharded (so
    the step's donation can alias) and the sharded step matches unsharded."""
    cfgs = default_cascade(n=32, lengths=(200.0, 50.0, 12.0, 3.0))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("expert",))
    plain = CascadeSolver(cfgs, real_state=True)
    sharded = CascadeSolver(cfgs, real_state=True, mesh=mesh)
    key = jax.random.PRNGKey(7)
    s1, s2 = plain.init(key), sharded.init(key)
    assert "expert" in str(s2.h0_re.sharding)       # pre-placed on the mesh
    for _ in range(2):
        s1, f1 = plain.step(s1, 1 / 60)
        s2, f2 = sharded.step(s2, 1 / 60)
    np.testing.assert_allclose(np.asarray(f2.height), np.asarray(f1.height),
                               atol=1e-4)


# ------------------------------------------------- live reconfigure (r3 #6)

def test_cascade_reconfigure_init_only_reuses_step_preserves_phase():
    """Init-only band changes (wind/amplitude/seed) re-render h0 and REUSE
    the compiled step; phase/t/step carry over so waves keep their motion
    (OceanRenderer.cs:98-109). Trajectory check: the reconfigured run equals
    a fresh solver fed the same new h0 and the preserved phase."""
    import dataclasses
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    solver = CascadeSolver(cfgs, fft_backend="reference")
    st = solver.init(jax.random.PRNGKey(0))
    dt = 1.0 / 60.0
    for _ in range(3):
        st, _ = solver.step(st, dt)
    phase_before = np.asarray(st.phase).copy()

    new_cfgs = [dataclasses.replace(c, wind=(4.0, 11.0), amplitude=0.9)
                for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert solver2._step_jit is solver._step_jit          # compiled reuse
    np.testing.assert_array_equal(np.asarray(st2.phase), phase_before)
    assert float(st2.t) == float(st.t)
    assert int(st2.step) == int(st.step)
    # h0 actually re-rendered (different wind/amplitude ⇒ different spectrum)
    assert np.abs(np.asarray(st2.h0) - np.asarray(st.h0)).max() > 0

    # trajectory continuity: a FRESH solver with the new cfgs, the same new
    # h0 draw, and the preserved phase must produce the same fields
    control = CascadeSolver(new_cfgs, fft_backend="reference")
    cst = control.init(jax.random.PRNGKey(new_cfgs[0].seed))
    # copy: the step donates its input state, and st2 shares these buffers
    cst = cst._replace(phase=jnp.copy(st.phase), t=jnp.copy(st.t),
                       step=jnp.copy(st.step))
    for _ in range(2):
        st2, f2 = solver2.step(st2, dt)
        cst, fc = control.step(cst, dt)
    np.testing.assert_allclose(np.asarray(f2.height), np.asarray(fc.height),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(st2.phase), np.asarray(cst.phase))


def test_cascade_reconfigure_structural_rebuilds():
    """Non-init-only changes (choppiness feeds a baked trace constant)
    rebuild the solver but still preserve phase on an unchanged grid."""
    import dataclasses
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    solver = CascadeSolver(cfgs, fft_backend="reference")
    st = solver.init(jax.random.PRNGKey(1))
    st, _ = solver.step(st, 1 / 60)
    new_cfgs = [dataclasses.replace(c, choppiness=1.3) for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert solver2._step_jit is not solver._step_jit
    np.testing.assert_array_equal(np.asarray(st2.phase), np.asarray(st.phase))
    st2, f2 = solver2.step(st2, 1 / 60)
    assert np.isfinite(np.asarray(f2.height)).all()
    with pytest.raises(ValueError, match="band"):
        solver.reconfigure(st, new_cfgs[:1])


def test_lod_reconfigure_rerenders_cache_keeps_schedule():
    """LOD reconfigure: init-only change re-renders the plane cache at each
    band's HELD phase (no motion pop), keeps the frame slot, and the
    schedule continues — held bands refresh at their next scheduled slot."""
    import dataclasses
    from tpu_ocean.lod import LODCascadeSolver
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    solver = LODCascadeSolver(cfgs, periods=(4, 1), fft_backend="reference")
    st = solver.init(jax.random.PRNGKey(2))
    for _ in range(2):
        st, _ = solver.step(st)
    phase_before = np.asarray(st.cascade.phase).copy()
    planes_before = np.asarray(st.planes).copy()

    new_cfgs = [dataclasses.replace(c, amplitude=2.0 * c.amplitude)
                for c in cfgs]
    solver2, st2 = solver.reconfigure(st, new_cfgs)
    assert st2.frame == st.frame                        # schedule slot kept
    for sub in solver._substeps:
        assert solver2._substeps[sub] is solver._substeps[sub]
    np.testing.assert_array_equal(np.asarray(st2.cascade.phase),
                                  phase_before)
    # cache re-rendered under the new spectrum (2× amplitude ⇒ planes move)
    assert np.abs(np.asarray(st2.planes) - planes_before).max() > 0
    st2, f2 = solver2.step(st2)
    assert st2.frame == st.frame + 1
    assert np.isfinite(np.asarray(f2.height)).all()


def test_cascade_simulation_reconfigure_live():
    """runtime.CascadeSimulation.reconfigure (was a NotImplementedError
    refusal): init-only per-band change mid-run, progress and phase kept."""
    import dataclasses
    from tpu_ocean.runtime import CascadeSimulation
    cfgs = default_cascade(n=32, lengths=(100.0, 13.0))
    sim = CascadeSimulation(cfgs, fft_backend="reference")
    sim.run(3)
    phase_before = np.asarray(sim.state.phase).copy()
    done = sim.step_count
    new_cfgs = [dataclasses.replace(c, wind=(3.0, 9.0)) for c in cfgs]
    sim.reconfigure(new_cfgs)
    assert sim.step_count == done
    np.testing.assert_array_equal(np.asarray(sim.state.phase), phase_before)
    f = sim.step()
    assert np.isfinite(np.asarray(f.height)).all()
    assert sim.cfgs == new_cfgs


def test_cascade_rejects_foam_decay():
    """CascadeState carries no foam accumulator: a config promising
    persistent foam must fail fast, not silently recompute instantaneous
    foam (review finding, r5)."""
    cfgs = default_cascade(n=32)
    bad = [cfgs[0].replace(foam_decay=0.5)] + cfgs[1:]
    with pytest.raises(ValueError, match="foam_decay"):
        CascadeSolver(bad)

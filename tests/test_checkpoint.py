"""Checkpoint/resume: restoring must continue the trajectory bitwise
(SURVEY.md §5.4 — the reference loses all state on exit)."""

import numpy as np
import jax

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.checkpoint import (
    save_checkpoint, load_checkpoint, CheckpointManager)


def _cfg():
    return OceanConfig(resolution=32, length=32.0, wind=(6.0, 4.0),
                       amplitude=0.05, evolution_mode="phase",
                       dispersion_mode="capillary", spectrum_layout="fft",
                       normals_mode="stencil")


def test_save_load_roundtrip(tmp_path):
    cfg = _cfg()
    solver = OceanSolver(cfg)
    state = solver.init(jax.random.PRNGKey(3))
    for _ in range(5):
        state, _ = solver.step(state, 1 / 60)

    p = str(tmp_path / "ckpt")
    save_checkpoint(p, state, cfg)
    restored, cfg2 = load_checkpoint(p)
    assert cfg2 == cfg
    for a, b in zip(state, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_is_bitwise_continuing(tmp_path):
    cfg = _cfg()
    solver = OceanSolver(cfg)
    state = solver.init(jax.random.PRNGKey(3))
    for _ in range(3):
        state, _ = solver.step(state, 1 / 60)
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, state, cfg)

    # continue without stopping
    cont = state
    for _ in range(4):
        cont, f_direct = solver.step(cont, 1 / 60)

    # stop, restore, continue
    restored, _ = load_checkpoint(p)
    for _ in range(4):
        restored, f_resumed = solver.step(restored, 1 / 60)

    np.testing.assert_array_equal(np.asarray(f_direct.height),
                                  np.asarray(f_resumed.height))
    np.testing.assert_array_equal(np.asarray(cont.phase),
                                  np.asarray(restored.phase))


def test_manager_interval_and_retention(tmp_path):
    cfg = _cfg()
    solver = OceanSolver(cfg)
    state = solver.init(jax.random.PRNGKey(0))
    mgr = CheckpointManager(str(tmp_path / "ckpts"), interval=2, keep=2)
    saved = []
    for _ in range(9):
        state, _ = solver.step(state, 1 / 60)
        p = mgr.maybe_save(state, cfg)
        if p:
            saved.append(p)
    assert len(saved) == 4          # steps 2, 4, 6, 8
    latest = mgr.latest()
    assert latest is not None and latest.endswith("state_0000000008.npz")
    st, _ = mgr.restore_latest()
    assert int(np.asarray(st.step)) == 8


def test_orbax_roundtrip(tmp_path):
    from tpu_ocean.checkpoint import (save_checkpoint_orbax,
                                      load_checkpoint_orbax)
    cfg = _cfg()
    solver = OceanSolver(cfg)
    state = solver.init(jax.random.PRNGKey(1))
    for _ in range(2):
        state, _ = solver.step(state, 1 / 60)
    d = str(tmp_path / "orbax_ckpt")
    save_checkpoint_orbax(d, state)
    restored = load_checkpoint_orbax(d)
    for a, b in zip(state, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_orbax_sharded_like_restore_both_representations(tmp_path):
    """load_checkpoint_orbax(like=...): leaves restore INTO like's shardings
    (the multi-process fleet's resume path, VERDICT r3 #4), across the
    representation pair — a real_state save restores as a complex view and
    vice versa (the plane wire format is shared with the npz family)."""
    from tpu_ocean.checkpoint import (save_checkpoint_orbax,
                                      load_checkpoint_orbax)
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    from tpu_ocean.solver import OceanStateReal
    cfg = OceanConfig(resolution=32, length=32.0, wind=(8.0, 5.0),
                      amplitude=0.5, spectrum_layout="fft",
                      normals_mode="stencil")
    mesh = make_mesh(shard=8)
    real = DistributedOceanSolver(cfg, mesh,
                                  real_state=True)
    st = real.init(jax.random.PRNGKey(3))
    for _ in range(2):
        st, _ = real.step(st, 1 / 60)
    d = str(tmp_path / "orbax_sharded")
    save_checkpoint_orbax(d, st)

    back = load_checkpoint_orbax(d, like=real.init(jax.random.PRNGKey(0)))
    assert isinstance(back, OceanStateReal)
    assert back.h0_re.sharding == st.h0_re.sharding
    for a, b in zip(st, back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resumed step == uninterrupted step, bitwise
    a1, f1 = real.step(real.shard_state(
        __import__("jax").tree.map(np.asarray, st)), 1 / 60)
    a2, f2 = real.step(back, 1 / 60)
    np.testing.assert_array_equal(np.asarray(f1.height),
                                  np.asarray(f2.height))

    # cross-representation: a COMPLEX distributed solver restores the same
    # snapshot as its own view, shard-layout intact
    cplx = DistributedOceanSolver(cfg, mesh)
    cview = load_checkpoint_orbax(d, like=cplx.init(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(np.asarray(jax.numpy.real(cview.h0)),
                                  np.asarray(st.h0_re))


def test_cascade_checkpoint_roundtrip_resumes_bitwise(tmp_path):
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.checkpoint import (save_cascade_checkpoint,
                                      load_cascade_checkpoint)
    cfgs = default_cascade(n=16)
    solver = CascadeSolver(cfgs)
    st = solver.init()
    for _ in range(3):
        st, _ = solver.step(st, 1 / 60)
    p = str(tmp_path / "casc.npz")
    save_cascade_checkpoint(p, st, cfgs)
    st2, cfgs2 = load_cascade_checkpoint(p)
    assert [c.length for c in cfgs2] == [c.length for c in cfgs]
    # continuing from the restore matches never having stopped, bitwise
    a, fa = solver.step(st, 1 / 60)
    b, fb = solver.step(st2, 1 / 60)
    np.testing.assert_array_equal(np.asarray(fa.height), np.asarray(fb.height))
    np.testing.assert_array_equal(np.asarray(a.phase), np.asarray(b.phase))


def test_loader_kind_mismatch_refused(tmp_path):
    """The single-patch and cascade loaders refuse each other's files with a
    clear error instead of a KeyError deep in the payload."""
    import pytest
    from tpu_ocean.cascade import CascadeSolver, default_cascade
    from tpu_ocean.checkpoint import (save_cascade_checkpoint,
                                      load_cascade_checkpoint)
    cfg = _cfg()
    solver = OceanSolver(cfg)
    p_single = str(tmp_path / "single.npz")
    save_checkpoint(p_single, solver.init(jax.random.PRNGKey(0)), cfg)
    with pytest.raises(ValueError, match="single-patch"):
        load_cascade_checkpoint(p_single)

    cfgs = default_cascade(n=16)
    csolver = CascadeSolver(cfgs)
    p_casc = str(tmp_path / "casc.npz")
    save_cascade_checkpoint(p_casc, csolver.init(), cfgs)
    with pytest.raises(ValueError, match="multi-band"):
        load_checkpoint(p_casc)


def test_cascade_checkpoint_periods_metadata(tmp_path):
    """The LOD refresh schedule rides the checkpoint; the peek reads it
    without uploading any state, and plain cascades report None."""
    from tpu_ocean.cascade import default_cascade
    from tpu_ocean.lod import LODCascadeSolver
    from tpu_ocean.checkpoint import (save_cascade_checkpoint,
                                      cascade_checkpoint_periods)
    cfgs = default_cascade(n=16)
    solver = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=1 / 60)
    st = solver.init()
    p = str(tmp_path / "lod.npz")
    save_cascade_checkpoint(p, st, cfgs, periods=solver.periods)
    assert cascade_checkpoint_periods(p) == [4, 2, 1]

    p2 = str(tmp_path / "lod_bare.npz")
    save_cascade_checkpoint(p2, st, cfgs)
    assert cascade_checkpoint_periods(p2) is None


def test_lod_checkpoint_roundtrip_resumes_bitwise(tmp_path):
    from tpu_ocean.cascade import default_cascade
    from tpu_ocean.lod import LODCascadeSolver
    from tpu_ocean.checkpoint import (save_cascade_checkpoint,
                                      load_cascade_checkpoint)
    cfgs = default_cascade(n=16)
    solver = LODCascadeSolver(cfgs, periods=[4, 2, 1], dt=1 / 60)
    st = solver.init()
    for _ in range(3):                      # stop mid-schedule (frame 3)
        st, _ = solver.step(st)
    p = str(tmp_path / "lod.npz")
    save_cascade_checkpoint(p, st, cfgs)
    st2, _ = load_cascade_checkpoint(p)
    assert st2.frame == st.frame == 3
    a, fa = solver.step(st)                 # frame 4: all bands refresh
    b, fb = solver.step(st2)
    np.testing.assert_array_equal(np.asarray(fa.height), np.asarray(fb.height))
    np.testing.assert_array_equal(np.asarray(a.planes), np.asarray(b.planes))


def test_real_state_simulation_checkpoint_resume(tmp_path):
    """real_state checkpoints and resumes through (re, im) plane pairs (the
    wire format either way), and the resumed trajectory continues bitwise —
    the production mode's lifecycle works."""
    import jax
    from tpu_ocean.runtime import Simulation

    cfg = OceanConfig(resolution=32, length=32.0, wind=(8.0, 5.0),
                      amplitude=0.4, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    kw = dict(real_state=True, pack_channels=True)
    out = str(tmp_path / "run")

    sim1 = Simulation(cfg, out_dir=out, checkpoint_every=2, **kw)
    for _ in range(2):
        sim1.step()
    sim1.close()

    # uninterrupted twin for the ground-truth trajectory
    ref = Simulation(cfg, **kw)
    for _ in range(4):
        f_ref = ref.step()

    sim2 = Simulation(cfg, out_dir=out, checkpoint_every=2, **kw)
    from tpu_ocean.solver import OceanStateReal
    assert isinstance(sim2.state, OceanStateReal)   # complex never formed
    assert sim2.step_count == 2
    for _ in range(2):
        f2 = sim2.step()
    sim2.close()
    np.testing.assert_array_equal(np.asarray(f2.height),
                                  np.asarray(f_ref.height))


def test_checkpoint_cross_representation_round_trip(tmp_path):
    """A checkpoint written by a REAL-state run restores into a complex
    solver (and vice versa) — one wire format, both representations."""
    from tpu_ocean.solver import OceanSolver, OceanStateReal

    cfg = OceanConfig(resolution=32, length=32.0, wind=(8.0, 5.0),
                      amplitude=0.4, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    import jax
    real = OceanSolver(cfg, real_state=True)
    sr = real.init(jax.random.PRNGKey(6))
    p = str(tmp_path / "real_ckpt")
    save_checkpoint(p, sr, cfg)

    import jax.numpy as jnp
    sc, cfg2 = load_checkpoint(p)                    # complex view
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(jnp.real(sc.h0)),
                                  np.asarray(sr.h0_re))
    sr2, _ = load_checkpoint(p, real_state=True)     # real view
    assert isinstance(sr2, OceanStateReal)
    np.testing.assert_array_equal(np.asarray(sr2.h0_im),
                                  np.asarray(sr.h0_im))


def test_orbax_sharded_like_restore_pre_foam_checkpoint(tmp_path):
    """A checkpoint written BEFORE foam_accum existed must still restore
    through the SHARDED (like=) path — the fleet-resume entry point —
    zero-filling the accumulator under like's sharding (review finding,
    r5; the legacy and npz loaders already tolerated it)."""
    import orbax.checkpoint as ocp
    from tpu_ocean.checkpoint import load_checkpoint_orbax, _orbax_tree
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.solver_dist import DistributedOceanSolver
    cfg = OceanConfig(resolution=32, length=32.0, wind=(8.0, 5.0),
                      amplitude=0.5, spectrum_layout="fft",
                      normals_mode="stencil")
    mesh = make_mesh(shard=4)
    solver = DistributedOceanSolver(cfg, mesh,
                                    real_state=True)
    state = solver.init(jax.random.PRNGKey(5))
    # simulate the OLD wire format: the saved tree has no foam_accum
    old = {k: v for k, v in _orbax_tree(state).items()
           if k != "foam_accum"}
    d = str(tmp_path / "old_orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(d, old, force=True)
    ckptr.wait_until_finished()
    restored = load_checkpoint_orbax(d, like=state)
    np.testing.assert_array_equal(np.asarray(restored.h0_re),
                                  np.asarray(state.h0_re))
    assert float(np.abs(np.asarray(restored.foam_accum)).max()) == 0.0
    assert restored.foam_accum.sharding == state.foam_accum.sharding

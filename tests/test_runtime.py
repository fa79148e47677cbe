"""Simulation runtime: run loop, metrics, checkpoint-resume, live reconfig."""

import os

import numpy as np
import jax

from tpu_ocean import OceanConfig, Simulation


def _cfg(resolution=32, **kw):
    base = dict(resolution=resolution, length=float(resolution),
                wind=(6.0, 4.0), amplitude=0.1,
                evolution_mode="phase", dispersion_mode="capillary",
                spectrum_layout="fft", normals_mode="stencil")
    base.update(kw)
    return OceanConfig(**base)


def test_run_loop_and_metrics(tmp_path):
    with Simulation(_cfg(), fft_backend="reference",
                    out_dir=str(tmp_path)) as sim:
        f = sim.run(5)
        assert sim.step_count == 5
        assert np.all(np.isfinite(np.asarray(f.height)))
        assert sim.metrics.summary()["steps"] >= 4


def test_auto_resume_from_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    sim1 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=2)
    sim1.run(6)
    phase1 = np.asarray(jax.device_get(sim1.state.phase))
    sim1.close()

    sim2 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=2)
    assert sim2.step_count == 6        # resumed, not restarted
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(sim2.state.phase)), phase1)
    sim2.run(2)
    assert sim2.step_count == 8
    sim2.close()


def test_export_every(tmp_path):
    out = str(tmp_path / "run")
    with Simulation(_cfg(), fft_backend="reference", out_dir=out,
                    export_every=2) as sim:
        sim.run(4)
    exported = os.listdir(os.path.join(out, "fields"))
    assert any("height" in f for f in exported)


def test_live_reconfigure(tmp_path):
    with Simulation(_cfg(), fft_backend="reference") as sim:
        sim.run(3)
        sim.reconfigure(_cfg(amplitude=0.5))
        assert sim.step_count == 3     # phase/step preserved
        sim.run(2)
        assert sim.step_count == 5


def test_resume_refuses_config_mismatch(tmp_path):
    import pytest
    out = str(tmp_path / "run")
    sim1 = Simulation(_cfg(), fft_backend="reference", out_dir=out,
                      checkpoint_every=1)
    sim1.run(2)
    sim1.close()
    with pytest.raises(ValueError, match="different config"):
        Simulation(_cfg(amplitude=0.9), fft_backend="reference",
                   out_dir=out, checkpoint_every=1)


def test_simulation_with_mesh():
    from tpu_ocean.parallel import make_mesh
    mesh = make_mesh(shard=8)
    with Simulation(_cfg(64), fft_backend="reference", mesh=mesh) as sim:
        f = sim.run(3)
        assert sim.step_count == 3
        assert f.height.shape == (64, 64)
        assert np.all(np.isfinite(np.asarray(f.height)))
        sim.reconfigure(_cfg(64, amplitude=0.5))
        sim.run(1)
        assert sim.step_count == 4


def test_cascade_simulation_lifecycle_and_resume(tmp_path):
    from tpu_ocean.cascade import default_cascade
    from tpu_ocean.runtime import CascadeSimulation
    cfgs = default_cascade(n=16)
    out = str(tmp_path / "casc_run")
    sim = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2)
    sim.run(4)
    assert sim.step_count == 4
    h4 = np.asarray(sim.fields.height).copy()
    sim.close()
    # resume from the step-4 checkpoint and continue
    sim2 = CascadeSimulation(cfgs, out_dir=out, checkpoint_every=2)
    assert sim2.step_count == 4
    sim2.run(1)
    # uninterrupted twin
    sim3 = CascadeSimulation(cfgs)
    sim3.run(5)
    np.testing.assert_array_equal(np.asarray(sim2.fields.height),
                                  np.asarray(sim3.fields.height))
    # config mismatch refusal
    import pytest
    other = default_cascade(n=16, lengths=(500.0, 130.0, 17.0))
    with pytest.raises(ValueError):
        CascadeSimulation(other, out_dir=out, checkpoint_every=2)


def test_cascade_simulation_lod_mode(tmp_path):
    from tpu_ocean.cascade import default_cascade
    from tpu_ocean.runtime import CascadeSimulation
    import pytest
    cfgs = default_cascade(n=16)
    out = str(tmp_path / "lod_run")
    sim = CascadeSimulation(cfgs, out_dir=out, periods=[2, 2, 1],
                            checkpoint_every=3)
    sim.run(3)
    sim.close()
    sim2 = CascadeSimulation(cfgs, out_dir=out, periods=[2, 2, 1],
                             checkpoint_every=3)
    assert sim2.step_count == 3          # resumed mid-schedule, host frame
    # kind mismatch: plain cascade sim refusing an LOD checkpoint
    with pytest.raises(ValueError):
        CascadeSimulation(cfgs, out_dir=out, checkpoint_every=3)
    # schedule mismatch: restored band caches are schedule-relative
    with pytest.raises(ValueError, match="schedule"):
        CascadeSimulation(cfgs, out_dir=out, periods=[4, 2, 1],
                          checkpoint_every=3)


def test_distributed_simulation_resume_is_sharded_and_bitwise(tmp_path):
    """Simulation(mesh=...) resume re-places the loaded host state onto the
    mesh layout (solver.shard_state) before the first donated step, and the
    resumed trajectory is bitwise the uninterrupted one — for BOTH state
    representations (the real-state resume stays complex-free)."""
    from tpu_ocean.parallel import make_mesh
    mesh = make_mesh(shard=8)
    for kw in (dict(fft_backend="reference"),
               dict(real_state=True)):
        out = str(tmp_path / f"dist_run_{kw.get('real_state', False)}")
        cfg = _cfg(32)
        with Simulation(cfg, out_dir=out, checkpoint_every=2, mesh=mesh,
                        **kw) as sim:
            sim.run(2)
            truth_state = sim.state
            # uninterrupted continuation as ground truth
            s3, f3 = sim.solver.step(
                __import__("jax").tree.map(np.asarray, truth_state), 1 / 60)
        with Simulation(cfg, out_dir=out, checkpoint_every=2, mesh=mesh,
                        **kw) as sim2:
            assert sim2.step_count == 2
            # the restored state is mesh-placed (not default single-device)
            leaf = (sim2.state.h0_re if hasattr(sim2.state, "h0_re")
                    else sim2.state.h0)
            assert len(leaf.sharding.device_set) == 8
            f = sim2.step()
            np.testing.assert_array_equal(np.asarray(f.height),
                                          np.asarray(f3.height))


def test_reconfigure_updates_metrics_grid_points():
    """Throughput lines divide by grid_points; a resolution change must
    not keep reporting against the old grid (review finding, r5)."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.runtime import Simulation
    cfg = OceanConfig(resolution=16, length=16.0, wind=(5.0, 3.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    sim = Simulation(cfg)
    sim.step()
    assert sim.metrics.grid_points == 16 * 16
    sim.reconfigure(cfg.replace(resolution=32, length=32.0))
    assert sim.metrics.grid_points == 32 * 32
    sim.step()

"""Simulation runtime — the orchestration layer around the jitted step.

The reference's runtime is Unity's MonoBehaviour loop: Awake() → Update() per
frame with live param re-init (OceanRenderer.cs:76-110). This module is its
production-framework equivalent: one object owning solver + state + metrics +
checkpointing + async export, with a run loop that keeps the device hot.

    sim = Simulation(cfg, out_dir="run0",
                     checkpoint_every=500, export_every=0)
    sim.run(steps=10_000)            # resumes automatically if out_dir has
    fields = sim.fields              # a checkpoint; emits JSONL metrics
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import jax

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.observe import Metrics
from tpu_ocean.checkpoint import CheckpointManager


class Simulation:
    """Owns the full lifecycle: init/resume → step loop → observe/persist."""

    def __init__(self, cfg: OceanConfig, fft_backend: str = "reference",
                 out_dir: Optional[str] = None, dt: float = 1.0 / 60.0,
                 checkpoint_every: int = 0, export_every: int = 0,
                 metrics_stream=None, seed_key: Optional[jax.Array] = None,
                 mesh=None, **solver_kw):
        self.cfg = cfg
        self.dt = dt
        # extra solver switches (pack_channels, real_state, half_spectrum,
        # overlap_chunks, ...) pass straight through to the solver
        if mesh is not None:
            # domain-decomposed runtime: same lifecycle, sharded solver
            from tpu_ocean.solver_dist import DistributedOceanSolver
            self.solver = DistributedOceanSolver(cfg, mesh,
                                                 fft_backend=fft_backend,
                                                 **solver_kw)
        else:
            self.solver = OceanSolver(cfg, fft_backend=fft_backend,
                                      **solver_kw)
        self.out_dir = out_dir
        self.metrics = Metrics(grid_points=cfg.resolution ** 2,
                               emit=metrics_stream)
        self.fields = None

        self._ckpt = None
        if out_dir and checkpoint_every:
            from tpu_ocean.checkpoint import load_checkpoint
            # real-state solvers resume straight into plane pairs
            want_real = bool(getattr(self.solver, "real_state", False))
            self._ckpt = CheckpointManager(
                os.path.join(out_dir, "ckpt"), interval=checkpoint_every,
                load_fn=lambda p: load_checkpoint(p, real_state=want_real))
        self._exporter = None
        self._export_every = export_every
        self._dropped_exports = 0

        restored = self._ckpt.restore_latest() if self._ckpt else (None, None)
        if restored[0] is not None:
            saved_cfg = restored[1]
            if saved_cfg is not None and saved_cfg != cfg:
                raise ValueError(
                    f"checkpoint in {out_dir!r} was written with a different "
                    f"config; refusing to silently continue it. Use a fresh "
                    f"out_dir, or Simulation(saved_cfg, ...) to resume "
                    f"(saved: {saved_cfg})")
            # symmetrize is a bitwise no-op on states a packing solver wrote
            # (OceanSolver.symmetrize: idempotent) and the Hermitian
            # projection on pre-packing checkpoints — safe either way
            state = restored[0]
            if hasattr(self.solver, "shard_state"):
                # distributed runtime: load_checkpoint returns host arrays;
                # place them onto the mesh layout BEFORE the first step so
                # the donated step aliases in place instead of resharding
                state = self.solver.shard_state(state)
            self.state = self.solver.symmetrize(state)
            import numpy as np
            self._steps_done = int(np.asarray(
                jax.device_get(self.state.step)))   # one pull at startup only
        else:
            self.state = self.solver.init(seed_key)
            self._steps_done = 0

        # exporter constructed AFTER the config-mismatch check above: raising
        # with a live native worker thread would leak it
        if out_dir and export_every:
            try:
                from tpu_ocean.native import AsyncExporter
                self._exporter = AsyncExporter(os.path.join(out_dir, "fields"))
            except Exception:   # no native toolchain: fall back to sync viz
                self._exporter = None

    @property
    def step_count(self) -> int:
        # tracked host-side: pulling state.step every step would force a
        # device sync per step
        return self._steps_done

    @property
    def world_length(self) -> float:
        """Physical extent (m) of the produced field planes — what a
        consumer (serve.FrameServer, renderers) needs to map texels to
        world space. CascadeSimulation overrides: combined planes span
        display_length (= max band), not band 0's length."""
        return self.cfg.length

    def step(self):
        """One solver step with metrics; returns the fields."""
        with self.metrics.measure(sim_dt=self.dt):
            self.state, self.fields = self.solver.step(self.state, self.dt)
            jax.block_until_ready(self.fields.height)
        self._steps_done += 1
        self._post_step()
        return self.fields

    def _post_step(self):
        k = self._steps_done
        if self._ckpt is not None:
            self._ckpt.maybe_save(self.state, self.cfg, step=k)
        if self._export_every and k % self._export_every == 0:
            self._export(k)

    def _export(self, k: int):
        import numpy as np
        if self._exporter is not None:
            for name in ("height", "foam"):
                ok = self._exporter.submit(
                    name, k, np.asarray(jax.device_get(
                        getattr(self.fields, name))))
                if not ok:
                    self._dropped_exports += 1
                    if self._dropped_exports in (1, 10, 100, 1000):
                        import sys
                        print(f"# exporter ring full: {self._dropped_exports}"
                              f" snapshot(s) dropped so far", file=sys.stderr)
        elif self.out_dir:
            from tpu_ocean import viz
            viz.save_fields(os.path.join(self.out_dir, "fields"),
                            self.fields, step=k)

    def run(self, steps: int,
            callback: Optional[Callable[["Simulation"], None]] = None):
        """Step ``steps`` times (on top of any resumed progress)."""
        for _ in range(steps):
            self.step()
            if callback is not None:
                callback(self)
        if self._exporter is not None:
            self._exporter.flush()
        return self.fields

    def reconfigure(self, new_cfg: OceanConfig):
        """Live parameter change (the reference's Update() re-init path)."""
        rebuilt = (new_cfg.resolution != self.cfg.resolution
                   or new_cfg.spectrum_layout != self.cfg.spectrum_layout)
        self.solver, self.state = self.solver.reconfigure(self.state, new_cfg)
        self.cfg = new_cfg
        if self.metrics is not None:
            # throughput lines divide by grid_points — keep them honest
            # across a resolution change
            self.metrics.grid_points = new_cfg.resolution ** 2
        if rebuilt:
            self._steps_done = 0   # full re-init: progress restarted

    def close(self):
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CascadeSimulation(Simulation):
    """The Simulation lifecycle over a multi-band cascade (cascade.py),
    optionally LOD-scheduled (lod.py when ``periods`` or ``camera_distance``
    is given). Same contract: auto-resume from out_dir with a config-mismatch
    refusal, JSONL metrics, periodic checkpoint/export.
    """

    def __init__(self, cfgs, fft_backend: str = "reference",
                 out_dir: Optional[str] = None, dt: float = 1.0 / 60.0,
                 periods=None, camera_distance: float = 0.0,
                 checkpoint_every: int = 0, export_every: int = 0,
                 metrics_stream=None, seed_key: Optional[jax.Array] = None,
                 pack_channels: bool = False, real_state: bool = False,
                 half_spectrum: bool = False):
        from tpu_ocean.cascade import CascadeSolver
        from tpu_ocean.checkpoint import (save_cascade_checkpoint,
                                          load_cascade_checkpoint)

        self.cfgs = list(cfgs)
        self.cfg = self.cfgs[0]            # parent-method compatibility
        self.dt = dt
        self._lod = periods is not None or camera_distance > 0
        if self._lod:
            from tpu_ocean.lod import LODCascadeSolver, periods_for_distance
            if periods is None:
                periods = periods_for_distance(self.cfgs, dt,
                                               camera_distance=camera_distance)
            self.solver = LODCascadeSolver(self.cfgs, periods=periods,
                                           fft_backend=fft_backend, dt=dt,
                                           pack_channels=pack_channels,
                                           real_state=real_state,
                                           half_spectrum=half_spectrum)
        else:
            self.solver = CascadeSolver(self.cfgs, fft_backend=fft_backend,
                                        pack_channels=pack_channels,
                                        real_state=real_state,
                                        half_spectrum=half_spectrum)
        self.out_dir = out_dir
        self.metrics = Metrics(grid_points=self.cfg.resolution ** 2,
                               emit=metrics_stream)
        self.fields = None
        self._exporter = None
        self._export_every = export_every
        self._dropped_exports = 0

        self._ckpt = None
        if out_dir and checkpoint_every:
            # LOD checkpoints carry their refresh schedule: restored phase
            # caches are only meaningful relative to the schedule that wrote
            # them, so resume validates it below
            periods_meta = list(self.solver.periods) if self._lod else None
            self._ckpt = CheckpointManager(
                os.path.join(out_dir, "ckpt"), interval=checkpoint_every,
                save_fn=lambda p, s, c: save_cascade_checkpoint(
                    p, s, c, periods=periods_meta),
                load_fn=lambda p: load_cascade_checkpoint(
                    p, real_state=real_state))

        restored = self._ckpt.restore_latest() if self._ckpt else (None, None)
        if restored[0] is not None:
            saved_cfgs = restored[1]
            if saved_cfgs is not None and list(saved_cfgs) != self.cfgs:
                raise ValueError(
                    f"checkpoint in {out_dir!r} was written with different "
                    f"band configs; refusing to silently continue it")
            state = restored[0]
            from tpu_ocean.lod import LODState
            if self._lod != isinstance(state, LODState):
                raise ValueError("checkpoint kind (lod vs plain cascade) "
                                 "does not match this simulation's mode")
            if self._lod:
                from tpu_ocean.checkpoint import cascade_checkpoint_periods
                saved_p = cascade_checkpoint_periods(self._ckpt.latest())
                if saved_p is not None and saved_p != list(self.solver.periods):
                    raise ValueError(
                        f"checkpoint in {out_dir!r} was written under LOD "
                        f"schedule {saved_p}, this simulation uses "
                        f"{list(self.solver.periods)}; restored band caches "
                        f"would be misaligned — use a fresh out_dir or the "
                        f"saved schedule")
            if self._lod:
                nch = self.solver.plane_count
                if state.planes.shape[1] > nch:
                    # pre-live-channel-cut checkpoint (5 cached planes with
                    # stencil cfgs): the leading planes are the live ones
                    state = state._replace(planes=state.planes[:, :nch])
                elif state.planes.shape[1] < nch:
                    raise ValueError(
                        f"checkpoint caches {state.planes.shape[1]} planes "
                        f"per band, this solver needs {nch} — it was "
                        f"written under a different normals_mode")
            # hermitize packed resumes (no-op for unpacked / already-packed
            # snapshots — CascadeSolver/LODCascadeSolver.symmetrize)
            self.state = self.solver.symmetrize(state)
            if self._lod:
                self._steps_done = state.frame   # host-side by design
            else:
                import numpy as np
                self._steps_done = int(np.asarray(
                    jax.device_get(state.step)))  # one pull at startup only
        else:
            self.state = self.solver.init(seed_key)
            self._steps_done = 0

        if out_dir and export_every:
            try:
                from tpu_ocean.native import AsyncExporter
                self._exporter = AsyncExporter(os.path.join(out_dir, "fields"))
            except Exception:
                self._exporter = None

    @property
    def world_length(self) -> float:
        inner = getattr(self.solver, "inner", self.solver)   # LOD wraps
        return inner.display_length

    def step(self):
        with self.metrics.measure(sim_dt=self.dt):
            if self._lod:
                self.state, self.fields = self.solver.step(self.state)
            else:
                self.state, self.fields = self.solver.step(self.state, self.dt)
            jax.block_until_ready(self.fields.height)
        self._steps_done += 1
        self._post_step()
        return self.fields

    def _post_step(self):
        k = self._steps_done
        if self._ckpt is not None:
            self._ckpt.maybe_save(self.state, self.cfgs, step=k)
        if self._export_every and k % self._export_every == 0:
            self._export(k)

    def reconfigure(self, new_cfgs):
        """Live per-band parameter change (the reference's Update() re-init
        path, OceanRenderer.cs:98-109, over the whole cascade — VERDICT r3
        #6). Init-only changes (wind/amplitude/spectrum shape/seed) cost one
        h0 re-render per band and reuse every compiled sub-step; the phase
        (and, under LOD, the refresh schedule and frame slot) is preserved,
        so waves keep their motion while the sea state morphs."""
        new_cfgs = list(new_cfgs)
        # band-count changes are REFUSED by CascadeSolver.reconfigure
        # (cascade.py raises before any state is touched), so they never
        # reach the rebuilt bookkeeping here
        rebuilt = (new_cfgs[0].resolution != self.cfg.resolution
                   or new_cfgs[0].spectrum_layout != self.cfg.spectrum_layout)
        self.solver, self.state = self.solver.reconfigure(self.state,
                                                          new_cfgs)
        self.cfgs = new_cfgs
        self.cfg = new_cfgs[0]
        if self.metrics is not None:
            self.metrics.grid_points = new_cfgs[0].resolution ** 2
        if rebuilt:
            self._steps_done = 0   # full re-init: progress restarted


class PondSimulation:
    """The serving-contract runtime for the Gerstner/sinusoid pond family
    (gerstner.PondSolver): cfg / dt / step() / step_count / state / solver —
    what serve.FrameServer consumes, so the pond streams through the same
    wire protocol as the ocean (the reference renders both families from
    one consumer loop, OceanRenderer.cs:91-110 + the pond material).

    The pond is stateless in t (the reference's vertex shader evaluates
    _Time directly, MistralWaterLib.cginc:81), so ``state`` IS the clock —
    which is exactly what PondSolver.velocity consumes, lining the serving
    path's ``solver.velocity(sim.state)`` call up across families."""

    def __init__(self, cfg, bank=None, normal_mode: str = "analytic",
                 dt: float = 1.0 / 60.0):
        from tpu_ocean.gerstner import PondSolver
        self.cfg = cfg
        self.dt = dt
        self.solver = PondSolver(cfg, bank=bank, normal_mode=normal_mode)
        self._steps_done = 0
        self.fields = None

    @property
    def step_count(self) -> int:
        return self._steps_done

    @property
    def state(self):
        return self._steps_done * self.dt      # t — see class docstring

    @property
    def world_length(self) -> float:
        return self.cfg.resolution * self.cfg.unit_width

    def step(self):
        self._steps_done += 1
        self.fields = self.solver.fields(self.state)
        jax.block_until_ready(self.fields.offset_y)
        return self.fields

    def run(self, steps: int):
        for _ in range(steps):
            self.step()
        return self.fields

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

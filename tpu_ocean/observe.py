"""Metrics, structured logging, and profiling hooks (SURVEY.md §5.1, §5.5).

The reference has neither profiling markers nor logging (not even Debug.Log).
Here observability is first-class: per-step structured records (step,
sim-time, wall-dt, grid-points/s, FFT updates/s), JSONL/CSV emitters that
BASELINE reporting consumes directly, and jax.profiler trace capture around
the hot loop for TensorBoard.

NaN guards: the reference's GPU pipeline silently propagates NaNs through 40+
blit passes; ``check_finite`` raises instead (jax.checkify-style but eager,
usable outside jit at checkpoint boundaries).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np
import jax


@dataclass
class StepRecord:
    step: int
    sim_time: float
    wall_dt_s: float
    grid_points_per_s: float
    updates_per_s: float
    extras: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"step": self.step, "sim_time": round(self.sim_time, 6),
             "wall_dt_s": round(self.wall_dt_s, 6),
             "grid_points_per_s": round(self.grid_points_per_s, 1),
             "updates_per_s": round(self.updates_per_s, 2)}
        d.update(self.extras)
        return d


class Metrics:
    """Wall-clock throughput counters around a stepping loop.

    Usage::

        m = Metrics(grid_points=cfg.resolution ** 2, emit=sys.stderr)
        for _ in range(k):
            with m.measure():
                state, f = solver.step(state, dt)
                jax.block_until_ready(f.height)
            # m.last is the StepRecord; JSONL already emitted if emit is set
    """

    def __init__(self, grid_points: int, emit: Optional[IO] = None,
                 emit_format: str = "jsonl"):
        self.grid_points = grid_points
        self.emit_stream = emit
        self.emit_format = emit_format
        self.records: list[StepRecord] = []
        self._step = 0
        self._sim_time = 0.0

    @contextlib.contextmanager
    def measure(self, sim_dt: float = 1.0 / 60.0, **extras):
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        self._step += 1
        self._sim_time += sim_dt
        rec = StepRecord(
            step=self._step, sim_time=self._sim_time, wall_dt_s=wall,
            grid_points_per_s=self.grid_points / wall if wall > 0 else 0.0,
            updates_per_s=1.0 / wall if wall > 0 else 0.0,
            extras=extras)
        self.records.append(rec)
        if self.emit_stream is not None:
            if self.emit_format == "jsonl":
                self.emit_stream.write(json.dumps(rec.as_dict()) + "\n")
            else:  # csv
                d = rec.as_dict()
                if len(self.records) == 1:
                    self.emit_stream.write(",".join(d.keys()) + "\n")
                self.emit_stream.write(
                    ",".join(str(v) for v in d.values()) + "\n")
            self.emit_stream.flush()

    @property
    def last(self) -> Optional[StepRecord]:
        return self.records[-1] if self.records else None

    def summary(self, warmup: int = 1) -> dict:
        """Aggregate over recorded steps, dropping the first ``warmup``
        (compile) entries."""
        recs = self.records[warmup:] or self.records
        if not recs:
            # a zero-step run (e.g. `--steps 0`) must report, not crash
            # with np.percentile's IndexError (review finding, r5)
            return {"steps": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "updates_per_s": 0.0,
                    "grid_points_per_s": 0.0}
        walls = np.asarray([r.wall_dt_s for r in recs])
        return {
            "steps": len(recs),
            "mean_ms": float(walls.mean() * 1e3),
            "p50_ms": float(np.percentile(walls, 50) * 1e3),
            "p95_ms": float(np.percentile(walls, 95) * 1e3),
            "updates_per_s": float(1.0 / walls.mean()),
            "grid_points_per_s": float(self.grid_points / walls.mean()),
        }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace around a block; open the result in TensorBoard,
    or reduce it with bench/trace_scopes.py. Wraps the hot loop the way the
    reference *should* have wrapped its 44 blits per frame. Block on the
    block's outputs INSIDE the window, or the asynchronously dispatched
    work may finish outside it."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def named_scope(name: str):
    """Per-stage trace annotation (SURVEY.md §5.1: named scopes per kernel)."""
    return jax.named_scope(name)


def check_finite(tree, where: str = "") -> None:
    """Raise FloatingPointError if any leaf holds a non-finite value."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(jax.device_get(leaf))
        if arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
            name = jax.tree_util.keystr(path)
            raise FloatingPointError(
                f"non-finite values in {name} {where and f'({where})'}")


def stage_breakdown(solver, state, dt: float = 1.0 / 60.0,
                    ks=(8, 32, 128)) -> dict:
    """Per-stage wall-clock breakdown WITHOUT a device profiler.

    Needs no profiler support and works on any backend (the device trace
    of bench/trace_scopes.py is the finer tool where a profiler runs). It
    times stage-subset programs with the K-ladder
    (benchlib.time_steps_ladder) and differences them:

        dispersion+assembly+transform  (state → spatial planes)
        dispersion only                (phase update)
        full step                      (adds field extraction + outputs)

    Returns {'full_ms', 'transform_ms', 'dispersion_ms', 'fields_ms',
    'assembly_transform_ms', validity flags}. Works for real-state
    solvers.
    """
    import jax
    import jax.numpy as jnp
    from tpu_ocean.benchlib import time_steps_ladder
    from tpu_ocean.solver import OceanStateReal

    if not isinstance(state, OceanStateReal):
        raise ValueError("stage_breakdown times the all-real step "
                         "(OceanSolver(real_state=True)); its stage "
                         "subsets reuse the real-state transform")

    c = solver._consts
    cfg = solver.cfg

    def phase_of(st, dtv, cc):
        from tpu_ocean.evolve import evolve_phase_accumulate
        if cfg.evolution_mode == "absolute":
            return cc["omega"] * (st.t + dtv / cfg.t_division)
        return evolve_phase_accumulate(st.phase, cc["omega"],
                                       dtv * cfg.dt_multiplier)

    # stage subsets as (state, dt, consts) -> (state, fields-ish) steppers —
    # the consts dict rides benchlib's ``extra`` as a REAL jit argument
    # (closing over the device arrays would embed them in the program).
    # Each stage advances a tiny recurrent carry so no iteration is dead.
    def step_full(st, dtv, cc):
        return solver._step_impl(st, dtv, cc)

    def step_dispersion(st, dtv, cc):
        ph = phase_of(st, dtv, cc)
        return st._replace(phase=ph, t=st.t + dtv), {"p": ph}

    def step_transform(st, dtv, cc):
        ph = phase_of(st, dtv, cc)
        out = solver._fields_from_phase_real(st, ph, cc)
        # stop before field extraction is impossible at the API level, so
        # transform-only is approximated by consuming only the spatial
        # planes the transform produced (height/disp) — XLA dead-codes the
        # stencil work when its outputs are unused
        return (st._replace(phase=ph, t=st.t + dtv),
                {"h": out.height, "dx": out.disp_x, "dz": out.disp_z})

    res = {}
    for name, fn in (("full", step_full), ("transform", step_transform),
                     ("dispersion", step_dispersion)):
        lad = time_steps_ladder(fn, state, dt, ks=ks, extra=c)
        res[f"{name}_ms"] = round(lad.per_step_s * 1e3, 4)
        res[f"{name}_suspect"] = lad.suspect
    res["fields_ms"] = round(res["full_ms"] - res["transform_ms"], 4)
    res["assembly_transform_ms"] = round(
        res["transform_ms"] - res["dispersion_ms"], 4)
    return res

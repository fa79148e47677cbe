"""Spray particle seeding — a consumer of the analytic velocity output.

Whitecap foam marks where the Jacobian pinches; spray launches where that
happens while the surface is moving UP. Each frame this example seeds
particles at texels with (foam > threshold AND ∂h/∂t > v_min) — both fields
the solver provides analytically (OceanSolver.velocity: iω-weighted
spectrum, no finite differencing) — then flies them ballistically and
renders the final frame with the airborne spray overlaid.

    python examples/spray.py --n 128 --steps 40 --out out/spray.png
"""


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys

import jax
import numpy as np

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver

G = 9.81


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--family", choices=["ocean", "pond"], default="ocean",
                    help="pond: Gerstner bank, seeded at fast-rising crests "
                         "(no foam field — gerstner_velocity + height gate)")
    ap.add_argument("--foam-thr", type=float, default=0.25)
    ap.add_argument("--v-min", type=float, default=0.5,
                    help="minimum upward surface speed (m/s) to launch")
    ap.add_argument("--max-new", type=int, default=200,
                    help="strongest launch sites kept per frame")
    ap.add_argument("--out", type=str, default="out/spray.png")
    args = ap.parse_args()
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    if args.family == "pond":
        return pond_main(args)

    cfg = OceanConfig(resolution=args.n, length=float(args.n),
                      wind=(13.0, 8.0), amplitude=0.8, choppiness=1.2,
                      evolution_mode="phase", dispersion_mode="capillary",
                      spectrum_layout="fft", normals_mode="stencil")
    solver = OceanSolver(cfg, fft_backend="matmul")
    state = solver.init(jax.random.PRNGKey(0))
    dt = 1.0 / 60.0

    # particles: [x, z, y, vy] rows (host-side — spray counts are tiny
    # next to the grid, and the consumer is render-side anyway)
    parts = np.zeros((0, 4), np.float32)
    spawned = 0
    fields = None
    for _ in range(args.steps):
        state, fields = solver.step(state, dt)
        vel = np.asarray(solver.velocity(state))
        foam = np.asarray(fields.foam)
        height = np.asarray(fields.height)

        # fly existing particles; drop the ones that fell back in
        if len(parts):
            parts[:, 2] += parts[:, 3] * dt
            parts[:, 3] -= G * dt
            ij = (parts[:, :2] * args.n / cfg.length).astype(int) % args.n
            parts = parts[parts[:, 2] > height[ij[:, 0], ij[:, 1]]]

        mask = (foam > args.foam_thr) & (vel > args.v_min)
        if mask.any():
            xi, zi = np.nonzero(mask)
            score = (foam * np.maximum(vel, 0.0))[xi, zi]
            keep = np.argsort(score)[::-1][:args.max_new]
            xi, zi = xi[keep], zi[keep]
            texel = cfg.length / args.n
            new = np.stack([xi * texel, zi * texel,
                            height[xi, zi], vel[xi, zi]], axis=1)
            parts = np.concatenate([parts, new.astype(np.float32)])
            spawned += len(new)
        print(f"# airborne {len(parts):5d}  (+{spawned} total spawned)",
              file=sys.stderr)

    from tpu_ocean import viz
    rgb = (viz.shade_ocean(fields) * 255).astype(np.uint8)
    if len(parts):
        ij = (parts[:, :2] * args.n / cfg.length).astype(int) % args.n
        rgb[ij[:, 0], ij[:, 1]] = (255, 255, 255)       # spray dots
    viz.write_png(args.out, rgb)
    print(f"spawned {spawned} spray particles over {args.steps} frames; "
          f"{len(parts)} airborne at the end; wrote {args.out}")
    return 0 if spawned > 0 else 1


def pond_main(args):
    """Spray on the pond family (VERDICT r3 #7): the Gerstner bank has no
    Jacobian foam, so launch sites are fast-RISING CRESTS — texels where the
    closed-form ∂h/∂t (gerstner.gerstner_velocity) exceeds v_min while the
    surface sits in the top height band. Same ballistic flight."""
    from tpu_ocean.config import PondConfig
    from tpu_ocean.runtime import PondSimulation

    cfg = PondConfig(resolution=args.n, amplitude=30.0, steepness=0.8)
    sim = PondSimulation(cfg, dt=1.0 / 60.0)
    texel = cfg.unit_width
    length = args.n * texel

    parts = np.zeros((0, 4), np.float32)
    spawned = 0
    fields = None
    for _ in range(args.steps):
        fields = sim.step()
        vel = np.asarray(sim.solver.velocity(sim.state))
        height = np.asarray(fields.offset_y)

        if len(parts):
            parts[:, 2] += parts[:, 3] * sim.dt
            parts[:, 3] -= G * sim.dt
            ij = (parts[:, :2] / texel).astype(int) % args.n
            parts = parts[parts[:, 2] > height[ij[:, 0], ij[:, 1]]]

        crest = height > np.quantile(height, 0.90)
        mask = crest & (vel > args.v_min)
        if mask.any():
            xi, zi = np.nonzero(mask)
            score = (np.maximum(vel, 0.0) * height)[xi, zi]
            keep = np.argsort(score)[::-1][:args.max_new]
            xi, zi = xi[keep], zi[keep]
            new = np.stack([xi * texel, zi * texel,
                            height[xi, zi], vel[xi, zi]], axis=1)
            parts = np.concatenate([parts, new.astype(np.float32)])
            spawned += len(new)
        print(f"# airborne {len(parts):5d}  (+{spawned} total spawned)",
              file=sys.stderr)

    from tpu_ocean import viz
    rgb = (viz.shade_pond(fields) * 255).astype(np.uint8)
    if len(parts):
        ij = (parts[:, :2] / texel).astype(int) % args.n
        rgb[ij[:, 0], ij[:, 1]] = (255, 255, 255)
    viz.write_png(args.out, rgb)
    print(f"spawned {spawned} pond spray particles over {args.steps} frames; "
          f"{len(parts)} airborne at the end; wrote {args.out} "
          f"(grid spans {length:.0f} m)")
    return 0 if spawned > 0 else 1


if __name__ == "__main__":
    sys.exit(main())

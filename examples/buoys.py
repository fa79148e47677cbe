"""Buoy probes on a live ocean — the consumer-side sampling API in action.

Drops K buoys on the surface, steps the ocean, and streams each buoy's
(surface height, displaced position) per step as CSV — the kind of signal a
vessel-dynamics or gameplay consumer reads.

    python examples/buoys.py --n 128 --buoys 5 --steps 120 > buoys.csv
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
from tpu_ocean.sample import buoy_heights, grid_origin, grid_period


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--buoys", type=int, default=5)
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    cfg = OceanConfig(resolution=args.n, length=float(args.n),
                      wind=(10.0, 6.0), amplitude=0.4,
                      evolution_mode="phase", dispersion_mode="capillary",
                      spectrum_layout="fft", normals_mode="stencil")
    solver = OceanSolver(cfg)
    state = solver.init(jax.random.PRNGKey(0))

    rng = np.random.default_rng(1)
    pos = rng.uniform(0, cfg.length, size=(args.buoys, 2)).astype(np.float32)
    origin = grid_origin(cfg)

    print("step," + ",".join(f"buoy{i}_h" for i in range(args.buoys)))
    probe = jax.jit(lambda f: buoy_heights(f, pos, grid_period(cfg), origin))
    for k in range(args.steps):
        state, fields = solver.step(state, 1.0 / 60.0)
        h = np.asarray(jax.device_get(probe(fields)))
        print(f"{k + 1}," + ",".join(f"{v:.5f}" for v in h))
    return 0


if __name__ == "__main__":
    sys.exit(main())

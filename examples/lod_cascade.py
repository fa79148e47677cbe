"""Camera-driven LOD over a 3-band cascade — per-band refresh rates.

Builds the standard production cascade (1000 m / 130 m / 17 m patches),
derives each band's refresh period from its temporal Nyquist margin plus a
camera-distance cap, then steps the schedule and reports how much FFT batch
work the schedule actually skipped vs. stepping every band every frame.

    python examples/lod_cascade.py --n 128 --steps 32 --camera 400
"""

from __future__ import annotations


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from tpu_ocean.cascade import default_cascade
from tpu_ocean.lod import LODCascadeSolver, periods_for_distance


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--camera", type=float, default=400.0,
                    help="camera distance (m) driving the LOD cap")
    ap.add_argument("--dt", type=float, default=1.0 / 60.0)
    args = ap.parse_args()

    cfgs = default_cascade(n=args.n)
    periods = periods_for_distance(cfgs, args.dt,
                                   camera_distance=args.camera)
    lod = LODCascadeSolver(cfgs, periods=periods, dt=args.dt)
    print(f"bands: lengths={[c.length for c in cfgs]} periods={periods} "
          f"schedule_len={lod.schedule_len} "
          f"distinct_substeps={len(lod._substeps)}")

    state = lod.init()
    refreshed = 0
    for f in range(1, args.steps + 1):
        subset = lod._slots[f % lod.schedule_len]
        refreshed += len(subset)
        state, fields = lod.step(state)
        if f % 8 == 0:
            h = np.asarray(fields.height)
            print(f"frame {f:3d}: refreshed bands {subset}  "
                  f"Hs={4.0 * h.std():.2f} m  foam_mean="
                  f"{float(np.asarray(fields.foam).mean()):.4f}")

    every_frame = lod.inner.b * args.steps
    print(f"band-FFT invocations: {refreshed}/{every_frame} "
          f"({100.0 * (1 - refreshed / every_frame):.0f}% skipped by the "
          f"schedule)")


if __name__ == "__main__":
    main()

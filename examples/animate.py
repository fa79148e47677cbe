"""Render an animated GIF of the evolving ocean — the demo-scene experience
without Unity. Uses the shaded-render path (viz.shade_ocean == the reference
material's fragment stage, TestOcean.shader:81-96).

    python examples/animate.py --res 256 --frames 90 --out ocean.gif
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

from tpu_ocean.config import OCEAN_DEMO
from tpu_ocean.solver import OceanSolver
from tpu_ocean import viz


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--every", type=int, default=2,
                    help="render every K-th step")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--out", type=str, default="ocean.gif")
    ap.add_argument("--backend", type=str, default="reference")
    args = ap.parse_args()

    from PIL import Image

    cfg = OCEAN_DEMO.replace(resolution=args.res, length=float(args.res))
    solver = OceanSolver(cfg, fft_backend=args.backend)
    state = solver.init(jax.random.PRNGKey(0))

    frames = []
    for k in range(args.frames * args.every):
        state, fields = solver.step(state, 1.0 / 60.0)
        if k % args.every == 0:
            rgb = (viz.shade_ocean(fields) * 255).astype(np.uint8)
            frames.append(Image.fromarray(rgb))
            if len(frames) % 20 == 0:
                print(f"# {len(frames)} frames", file=sys.stderr)

    frames[0].save(args.out, save_all=True, append_images=frames[1:],
                   duration=int(1000 / args.fps), loop=0)
    print(f"# wrote {args.out}: {len(frames)} frames at {args.res}^2",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sea-state inversion by adjoint optimization — a capability demo.

Because the entire solver is differentiable JAX (docs/design.md), the inverse
problem "which initial spectrum h0 produced this observed heightfield?" is a
gradient descent, structurally impossible in the reference's shader pipeline:

    1. draw a ground-truth h0*, step the ocean, record height snapshots
    2. start from h0 = 0 and minimize Σ_t ‖height(h0, t) − obs_t‖²
    3. recover h0 (up to the observability limit of the snapshots)

Run: python examples/invert_sea_state.py  [--steps 120] [--n 64] [--packed]
Small grids; runs on whatever device JAX picks (JAX_PLATFORMS=cpu for CPU).
"""


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys

import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver


def packed_problem(n: int, snapshots: int):
    """(loss, truth) of the inversion on the SHIPPING pipeline (VERDICT r4
    #4): all-real state, Hermitian channel packing, half-spectrum C2R route
    on jnp.fft — the exact bench.py headline switch set. ``jax.grad``
    differentiates through the production step itself (jnp.fft carries its
    own transpose rules). ``loss`` takes the (h0_re, h0_im) planes; the
    conjugate-partner planes are DERIVED each call (Hermitian-preserving
    parameterization — the only direction the linear Tessendorf sum,
    FFTMesh.cs:192-220, is observable in)."""
    if n % 2:
        raise SystemExit("--packed needs an even n (half-spectrum route)")
    cfg = OceanConfig(resolution=n, length=float(n), wind=(8.0, 5.0),
                      amplitude=0.05, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = OceanSolver(cfg, real_state=True, pack_channels=True,
                         half_spectrum=True)
    truth = solver.init(jax.random.PRNGKey(0))
    dt = jnp.float32(1.0 / 30.0)
    inner = 3    # solver steps between observation snapshots

    def observe(planes):
        """Unroll snapshots·inner steps from zero phase; heights at each
        snapshot — differentiable in the h0 planes."""
        h0_re, h0_im = planes
        st = truth._replace(
            h0_re=h0_re, h0_im=h0_im,
            h0c_re=jnp.roll(jnp.flip(h0_re, (0, 1)), (1, 1), (0, 1)),
            h0c_im=-jnp.roll(jnp.flip(h0_im, (0, 1)), (1, 1), (0, 1)),
            phase=jnp.zeros_like(truth.phase))
        hs = []
        for _ in range(snapshots):
            for _ in range(inner):
                st, f = solver._step_impl(st, dt, solver._consts)
            hs.append(f.height)
        return hs

    obs = [jax.lax.stop_gradient(h)
           for h in observe((truth.h0_re, truth.h0_im))]

    def loss(planes):
        err = 0.0
        for h, o in zip(observe(planes), obs):
            err = err + jnp.mean((h - o) ** 2)
        return err / len(obs)

    return loss, truth


def run_packed(args) -> int:
    """Adam on :func:`packed_problem`'s loss, from h0 = 0."""
    loss, truth = packed_problem(args.n, args.snapshots)
    grad = jax.jit(jax.value_and_grad(loss))
    planes = (jnp.zeros_like(truth.h0_re), jnp.zeros_like(truth.h0_im))
    m = [jnp.zeros_like(p) for p in planes]
    v = [jnp.zeros_like(p) for p in planes]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(args.steps):
        val, g = grad(planes)
        new = []
        for j, (p, gj) in enumerate(zip(planes, g)):
            m[j] = b1 * m[j] + (1 - b1) * gj
            v[j] = b2 * v[j] + (1 - b2) * gj ** 2
            mh = m[j] / (1 - b1 ** (i + 1))
            vh = v[j] / (1 - b2 ** (i + 1))
            new.append(p - args.lr * mh / (jnp.sqrt(vh) + eps))
        planes = tuple(new)
        if i % 25 == 0 or i == args.steps - 1:
            tr = jnp.sqrt(jnp.sum((planes[0] - truth.h0_re) ** 2)
                          + jnp.sum((planes[1] - truth.h0_im) ** 2))
            tn = jnp.sqrt(jnp.sum(truth.h0_re ** 2)
                          + jnp.sum(truth.h0_im ** 2))
            print(f"iter {i:4d}  loss {float(val):.3e}  "
                  f"rel |h0 - h0*| {float(tr / tn):.3f}", flush=True)

    loss_jit = jax.jit(loss)
    final = float(loss_jit(planes))
    init = float(loss_jit((jnp.zeros_like(truth.h0_re),
                           jnp.zeros_like(truth.h0_im))))
    print(f"loss reduced {init:.3e} → {final:.3e} "
          f"({init / max(final, 1e-30):.1f}×)")
    return 0 if final < init * 1e-2 else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--snapshots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--packed", action="store_true",
                    help="invert on the production packed real-state + "
                         "half-spectrum pipeline (needs an even n)")
    args = ap.parse_args()

    if args.packed:
        return run_packed(args)

    n = args.n
    cfg = OceanConfig(resolution=n, length=float(n), wind=(8.0, 5.0),
                      amplitude=0.05, evolution_mode="absolute",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="spectral")
    solver = OceanSolver(cfg)

    truth = solver.init(jax.random.PRNGKey(0))
    times = [0.5 + 0.37 * i for i in range(args.snapshots)]
    obs = [solver.fields_at(truth, t).height for t in times]

    base = truth._replace(h0=jnp.zeros_like(truth.h0),
                          h0_conj=jnp.zeros_like(truth.h0_conj))

    def partner(h0):
        # conjugate-partner layout for fft ordering: h0*[(N−n) mod N]
        return jnp.conj(jnp.roll(jnp.flip(h0, (0, 1)), (1, 1), (0, 1)))

    def loss(h0):
        st = base._replace(h0=h0, h0_conj=partner(h0))
        err = 0.0
        for t, o in zip(times, obs):
            err = err + jnp.mean((solver.fields_at(st, t).height - o) ** 2)
        return err / len(times)

    grad = jax.jit(jax.value_and_grad(loss))
    h0 = jnp.zeros_like(truth.h0)
    # Adam
    m = jnp.zeros_like(h0)
    v = jnp.zeros_like(jnp.real(h0))
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(args.steps):
        val, g = grad(h0)
        g = jnp.conj(g)   # Wirtinger: descend on conj gradient for real loss
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * jnp.abs(g) ** 2
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        h0 = h0 - args.lr * mh / (jnp.sqrt(vh) + eps)
        if i % 25 == 0 or i == args.steps - 1:
            rel = float(jnp.linalg.norm(h0 - truth.h0)
                        / jnp.linalg.norm(truth.h0))
            print(f"iter {i:4d}  loss {float(val):.3e}  "
                  f"rel |h0 - h0*| {rel:.3f}", flush=True)

    final = float(grad(h0)[0])
    init = float(loss(jnp.zeros_like(h0)))
    print(f"loss reduced {init:.3e} → {final:.3e} "
          f"({init / max(final, 1e-30):.1f}×)")
    return 0 if final < init * 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())

"""GSPMD rung of the sharding ladder: jit the SINGLE-DEVICE step under
sharding annotations and let XLA's SPMD partitioner choose the collectives.

The scaling-book recipe ("pick a mesh, annotate shardings, let XLA insert
collectives, profile, iterate") has two rungs in this framework:

1. **This module** — zero new math: `jax.jit(OceanSolver._step_impl,
   in_shardings=…, out_shardings=…)` with the same contract as the hand
   solver (state rows-sharded in, fields columns-sharded out). The
   partitioner is free to replicate, all_gather, or transpose as it likes.
2. **The production path** (`solver_dist.DistributedOceanSolver`) — the
   shard_map step that tells XLA *exactly* which collectives to run: one
   stacked all_to_all transpose and six halo ppermutes per step.

Keeping rung 1 alive serves two purposes: it is the five-line idiomatic
answer a JAX user reaches for first (and it is *correct* — tested against
the single-device step), and compiling both rungs on the fake mesh lets
`bench/scaling_model.py` quantify exactly what the hand design buys
(`gspmd_collective_report`): the partitioner must respect the annotated
row→column re-layout but cannot see that the 2-D transform's own middle
state is layout-free, so it moves strictly more bytes (extra reshard
collectives around the transform instead of the single minimal transpose,
plus all_gathers wherever an op wants a full axis). The quantified gap
lives in bench/scaling_model.md.

Reference anchor: the whole module replaces OceanRenderer.cs's single-GPU
assumption (one device owns all 8×128 blits, OceanRenderer.cs:136) with a
mesh contract — there is no reference equivalent to cite beyond that.

Plane-state (real_state) solvers are rejected: the annotated layout contract
is written for the complex OceanState.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_ocean.solver import OceanSolver, OceanState, OceanFields

def _state_specs(x: P) -> OceanState:
    return OceanState(h0=x, h0_conj=x, phase=x, t=P(), step=P(),
                      foam_accum=x)


def _field_specs(z: P) -> OceanFields:
    z3 = P(*z, None)
    return OceanFields(height=z, disp_x=z, disp_z=z, pos_x=z, pos_z=z,
                       normal=z3, foam=z, jacobian=z)


def make_gspmd_step(solver: OceanSolver, mesh: Mesh,
                    shard_axis: str = "shard"):
    """Compile ``solver``'s step under GSPMD with the hand solver's layout
    contract (rows-sharded state in, columns-sharded fields out).

    Returns ``(step, place_state)``: ``step(state, dt)`` is the jitted
    sharded step (donating the state like the single-device one), and
    ``place_state(state)`` device_puts an OceanState onto the mesh with the
    input layout. Use with a state from ``solver.init()``::

        step, place = make_gspmd_step(solver, make_mesh(shard=8))
        state = place(solver.init(jax.random.PRNGKey(0)))
        state, fields = step(state, 1 / 60)
    """
    if shard_axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a {shard_axis!r} axis "
                         f"(got {mesh.axis_names})")
    if getattr(solver, "real_state", False):
        raise ValueError("the GSPMD step annotates the complex OceanState; "
                         "build the solver with real_state=False or use "
                         "DistributedOceanSolver")

    x_spec = P(shard_axis, None)      # state rows split (hand-solver layout)
    z_spec = P(None, shard_axis)      # field columns split

    def sh(spec: P) -> NamedSharding:
        return NamedSharding(mesh, spec)

    state_sh = jax.tree.map(sh, _state_specs(x_spec))
    field_sh = jax.tree.map(sh, _field_specs(z_spec))
    # constants follow the state orientation; the partitioner reshards the
    # few it wants elsewhere (x0/z0 are consumed at the field stage, so give
    # them the output orientation up front)
    def const_spec(k, v):
        if k in ("x0", "z0"):
            return z_spec
        if v.ndim == 3 and v.shape[1] % mesh.shape[shard_axis] == 0:
            return P(None, shard_axis, None)   # [C, N, N] channel coeffs
        if v.ndim == 3:
            return P()       # row slices (pack_nyq [2P, 1, N]): replicate
        return x_spec                   # [N, N] grids (omega, modulation)
    consts_sh = {k: sh(const_spec(k, v)) for k, v in solver._consts.items()}

    step = jax.jit(solver._step_impl,
                   in_shardings=(state_sh, sh(P()), consts_sh),
                   out_shardings=(state_sh, field_sh),
                   donate_argnums=(0,))

    def place_state(state: OceanState) -> OceanState:
        return jax.device_put(state, state_sh)

    def run(state: OceanState, dt):
        import jax.numpy as jnp
        return step(state, jnp.asarray(dt, jnp.float32), solver._consts)

    run.lowered = lambda state: step.lower(   # for HLO inventory tooling
        state, jax.numpy.float32(1 / 60), solver._consts)
    return run, place_state

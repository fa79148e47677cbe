"""Ensemble (data-parallel) ocean solving — component D2.

The reference runs exactly one patch per GPU. On a device mesh, a batch of
independent ocean patches (an ensemble: different seeds, same physics) shards
trivially over a 'batch' axis — the DP analogue, no communication at all.
Combined with the 'shard' domain-decomposition axis (solver_dist), the mesh
('batch', 'shard') covers DP × SP for grids that are both many and large.

This module vmaps the single-patch step over a leading ensemble axis and lays
the state out with `NamedSharding(mesh, P('batch', ...))`; XLA partitions the
whole vmapped computation with zero collectives.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver, OceanState


class EnsembleOceanSolver:
    """A batch of independent patches stepped in one jitted call.

    ``mesh`` needs a 'batch' axis; each member's state/fields get sharding
    P('batch') on the leading ensemble dimension.
    """

    def __init__(self, cfg: OceanConfig, mesh: Mesh, ensemble_size: int,
                 fft_backend: str = "reference", **solver_kw):
        if "batch" not in mesh.axis_names:
            raise ValueError("mesh needs a 'batch' axis (parallel.make_mesh)")
        n_batch = mesh.shape["batch"]
        if ensemble_size % n_batch != 0:
            raise ValueError(f"ensemble_size {ensemble_size} not divisible by "
                             f"batch axis size {n_batch}")
        self.cfg = cfg
        self.mesh = mesh
        self.ensemble_size = ensemble_size
        # extra member-solver switches (pack_channels, real_state,
        # half_spectrum, ...) pass straight through — every member variant the
        # single-patch solver supports ensembles identically
        self._inner = OceanSolver(cfg, fft_backend=fft_backend, **solver_kw)

        def spec(*tail):
            return NamedSharding(mesh, P("batch", *tail))

        if getattr(self._inner, "real_state", False):
            from tpu_ocean.solver import OceanStateReal
            state_shardings = OceanStateReal(
                h0_re=spec(), h0_im=spec(), h0c_re=spec(), h0c_im=spec(),
                phase=spec(), t=spec(), step=spec(), foam_accum=spec())
        else:
            state_shardings = OceanState(
                h0=spec(), h0_conj=spec(), phase=spec(), t=spec(),
                step=spec(), foam_accum=spec())
        # constants ride as a (replicated) jit argument — embedding them in
        # the program bloats it and re-fetching closures is unreliable
        vstep = jax.vmap(self._inner._step_impl, in_axes=(0, None, None))
        self._step_jit = jax.jit(vstep, donate_argnums=(0,),
                                 in_shardings=(state_shardings, None, None))

    def init(self, key: Optional[jax.Array] = None) -> OceanState:
        """Member i draws its own h0 from fold_in(key, i)."""
        if key is None:
            key = jax.random.PRNGKey(self.cfg.seed)
        keys = jax.random.split(key, self.ensemble_size)
        states = jax.vmap(self._inner.init)(keys)
        sh = NamedSharding(self.mesh, P("batch"))
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sh), states)

    def step(self, state: OceanState, dt: float = 1.0 / 60.0):
        """[E, ...] state → ([E, ...] state, [E, ...] fields)."""
        return self._step_jit(state, jnp.asarray(dt, jnp.float32),
                              self._inner._consts)


class EnsembleDistributedSolver:
    """DP × SP composition: an ensemble of DOMAIN-DECOMPOSED patches.

    Each ensemble member's grid is itself sharded over the mesh's 'shard'
    axis (all the DistributedOceanSolver machinery — all_to_all FFT
    transpose, halo rings) while the member axis shards over 'batch':
    the full ('batch', 'shard') mesh is active for one step call. Built by
    vmapping the shard_map'ped member step — the composition JAX is designed
    for; no new collectives are written.
    """

    def __init__(self, cfg, mesh: Mesh, ensemble_size: int,
                 fft_backend: str = "reference", overlap_chunks: int = 1,
                 **solver_kw):
        from tpu_ocean.solver_dist import DistributedOceanSolver

        for axis in ("batch", "shard"):
            if axis not in mesh.axis_names:
                raise ValueError(f"mesh needs a {axis!r} axis")
        n_batch = mesh.shape["batch"]
        if ensemble_size % n_batch != 0:
            raise ValueError(f"ensemble_size {ensemble_size} not divisible "
                             f"by batch axis size {n_batch}")
        self.cfg = cfg
        self.mesh = mesh
        self.ensemble_size = ensemble_size
        self._inner = DistributedOceanSolver(
            cfg, mesh, fft_backend=fft_backend,
            overlap_chunks=overlap_chunks, **solver_kw)

        # placement comes from init's device_put; jit propagates it.
        # vmap the per-member shard_map'ped body over the leading member
        # axis; spmd_axis_name tells the inner shard_map the mapped axis
        # lives on the mesh's 'batch' axis
        vstep = jax.vmap(self._inner._sharded_step,
                         in_axes=(0,) + (None,) * 9,
                         spmd_axis_name="batch")
        self._step_jit = jax.jit(vstep, donate_argnums=(0,))

    def init(self, key=None):
        if key is None:
            key = jax.random.PRNGKey(self.cfg.seed)
        keys = jax.random.split(key, self.ensemble_size)
        members = [self._inner.init(k) for k in keys]
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *members)
        if getattr(self._inner, "real_state", False):
            # all-real composition: the member step's state specs are the
            # OceanStateReal pytree, so DP × SP stays complex-free end to end
            from tpu_ocean.solver import OceanStateReal
            cls = OceanStateReal
            shard_tail = {"h0_re": ("shard",), "h0_im": ("shard",),
                          "h0c_re": ("shard",), "h0c_im": ("shard",),
                          "phase": ("shard",), "t": (), "step": (),
                          "foam_accum": (None, "shard")}
        else:
            cls = OceanState
            shard_tail = {"h0": ("shard",), "h0_conj": ("shard",),
                          "phase": ("shard",), "t": (), "step": (),
                          "foam_accum": (None, "shard")}
        put = {f: jax.device_put(getattr(stacked, f),
                                 NamedSharding(self.mesh,
                                               P("batch", *shard_tail[f])))
               for f in cls._fields}
        return cls(**put)

    def step(self, state: OceanState, dt: float = 1.0 / 60.0):
        """[E, ...] sharded state → ([E, ...] state, [E, ...] fields)."""
        i = self._inner
        return self._step_jit(state, jnp.asarray(dt, jnp.float32),
                              i._omega, i._coeffs,
                              i._pre_re, i._pre_im, i._post_re, i._post_im,
                              i._x0, i._z0)

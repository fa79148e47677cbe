"""Ensemble (DP) solver and transpose-overlap chunking on the fake-CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.solver_dist import DistributedOceanSolver
from tpu_ocean.ensemble import EnsembleOceanSolver
from tpu_ocean.parallel import make_mesh


def _cfg(n=32):
    return OceanConfig(resolution=n, length=float(n), wind=(6.0, 4.0),
                       amplitude=0.05, evolution_mode="phase",
                       dispersion_mode="capillary", spectrum_layout="fft",
                       normals_mode="stencil")


def test_ensemble_members_match_single_patch():
    cfg = _cfg()
    mesh = make_mesh(batch=4, shard=2)
    ens = EnsembleOceanSolver(cfg, mesh, ensemble_size=4)
    key = jax.random.PRNGKey(9)
    state = ens.init(key)
    state, fields = ens.step(state, 1 / 60)
    state, fields = ens.step(state, 1 / 60)
    assert fields.height.shape == (4, 32, 32)

    # member i must equal a standalone solver run with the same key
    single = OceanSolver(cfg)
    keys = jax.random.split(key, 4)
    for i in [0, 3]:
        st = single.init(keys[i])
        st, f = single.step(st, 1 / 60)
        st, f = single.step(st, 1 / 60)
        np.testing.assert_allclose(np.asarray(fields.height[i]),
                                   np.asarray(f.height), atol=1e-5)


def test_ensemble_size_validation():
    mesh = make_mesh(batch=4, shard=2)
    with pytest.raises(ValueError):
        EnsembleOceanSolver(_cfg(), mesh, ensemble_size=3)


@pytest.mark.parametrize("chunks,backend", [(1, "reference"), (3, "reference"),
                                            (3, "matmul")])
def test_overlap_chunks_identical_results(chunks, backend):
    cfg = _cfg(32)
    mesh = make_mesh(shard=8)
    base = DistributedOceanSolver(cfg, mesh)
    over = DistributedOceanSolver(cfg, mesh, overlap_chunks=chunks,
                                  fft_backend=backend)
    key = jax.random.PRNGKey(2)
    s1 = base.init(key)
    s2 = over.init(key)
    for _ in range(2):
        s1, f1 = base.step(s1, 1 / 60)
        s2, f2 = over.step(s2, 1 / 60)
    if backend == "reference":
        np.testing.assert_array_equal(np.asarray(f1.height),
                                      np.asarray(f2.height))
        np.testing.assert_array_equal(np.asarray(f1.foam),
                                      np.asarray(f2.foam))
    else:   # matmul four-step: fp32-equivalent, not bit-identical
        np.testing.assert_allclose(np.asarray(f2.height),
                                   np.asarray(f1.height), atol=2e-5)


def test_ensemble_of_distributed_patches_matches_members():
    """DP × SP: each member both batched AND domain-decomposed; member 0
    must reproduce a standalone distributed run with the same key."""
    from tpu_ocean.ensemble import EnsembleDistributedSolver
    cfg = _cfg(32)
    mesh = make_mesh(batch=2, shard=4)
    combo = EnsembleDistributedSolver(cfg, mesh, ensemble_size=2)
    key = jax.random.PRNGKey(11)
    st = combo.init(key)
    st, f = combo.step(st, 1 / 60)
    st, f = combo.step(st, 1 / 60)
    assert f.height.shape == (2, 32, 32)

    solo = DistributedOceanSolver(cfg, make_mesh(shard=8))
    keys = jax.random.split(key, 2)
    for i in range(2):
        s0 = solo.init(keys[i])
        for _ in range(2):
            s0, f0 = solo.step(s0, 1 / 60)
        np.testing.assert_allclose(np.asarray(f.height[i]),
                                   np.asarray(f0.height), atol=2e-5)


def test_dp_sp_composition_with_fused_backend():
    """DP × SP (spmd-vmapped shard_map) composes with the shipping switch
    set (plane state, packing, the mirror-balanced sharded C2R)."""
    from tpu_ocean.ensemble import EnsembleDistributedSolver
    from tpu_ocean.solver import PRODUCTION
    cfg = _cfg(32)
    mesh = make_mesh(batch=2, shard=4)
    combo = EnsembleDistributedSolver(cfg, mesh, ensemble_size=2,
                                      **PRODUCTION)
    st = combo.init(jax.random.PRNGKey(3))
    st, f = combo.step(st, 1 / 60)
    assert f.height.shape == (2, 32, 32)
    assert np.isfinite(np.asarray(f.height)).all()


def test_ensemble_threads_member_solver_switches():
    """pack_channels / real_state / half_spectrum pass through to every
    member: the packed-real ensemble matches standalone packed-real solvers
    member-exactly (the production member variant ensembles identically)."""
    from tpu_ocean.solver import OceanStateReal
    cfg = _cfg()
    mesh = make_mesh(batch=4, shard=2)
    kw = dict(real_state=True, pack_channels=True)
    ens = EnsembleOceanSolver(cfg, mesh, ensemble_size=4, **kw)
    key = jax.random.PRNGKey(9)
    state = ens.init(key)
    assert isinstance(state, OceanStateReal)
    state, fields = ens.step(state, 1 / 60)

    single = OceanSolver(cfg, **kw)
    keys = jax.random.split(key, 4)
    for i in [0, 2]:
        st = single.init(keys[i])
        st, f = single.step(st, 1 / 60)
        np.testing.assert_allclose(np.asarray(fields.height[i]),
                                   np.asarray(f.height), atol=1e-5)
        np.testing.assert_allclose(np.asarray(fields.foam[i]),
                                   np.asarray(f.foam), atol=1e-5)

    # DP × SP composition threads too
    from tpu_ocean.ensemble import EnsembleDistributedSolver
    combo = EnsembleDistributedSolver(cfg, mesh, ensemble_size=4,
                                      pack_channels=True)
    cstate = combo.init(key)
    cstate, cfields = combo.step(cstate, 1 / 60)
    assert cfields.height.shape == (4, 32, 32)
    assert np.isfinite(np.asarray(cfields.height)).all()


def test_dp_sp_composition_real_state():
    """DP × SP with real_state=True: the composed step runs on the
    OceanStateReal pytree and member 0 matches a
    standalone real-state distributed run with the same key."""
    from tpu_ocean.ensemble import EnsembleDistributedSolver
    from tpu_ocean.solver import OceanStateReal
    cfg = _cfg(32)
    mesh = make_mesh(batch=2, shard=4)
    combo = EnsembleDistributedSolver(cfg, mesh, ensemble_size=2,
                                      real_state=True)
    key = jax.random.PRNGKey(13)
    st = combo.init(key)
    assert isinstance(st, OceanStateReal)
    for _ in range(2):
        st, f = combo.step(st, 1 / 60)
    assert f.height.shape == (2, 32, 32)

    solo = DistributedOceanSolver(_cfg(32), make_mesh(shard=8),
                                  real_state=True)
    keys = jax.random.split(key, 2)
    for i in range(2):
        s0 = solo.init(keys[i])
        for _ in range(2):
            s0, f0 = solo.step(s0, 1 / 60)
        np.testing.assert_allclose(np.asarray(f.height[i]),
                                   np.asarray(f0.height), atol=2e-5)

"""GSPMD rung (parallel/gspmd.py): the single-device step jitted under
sharding annotations must agree with the single-device trajectory, and its
partitioner-chosen collectives must be measurably WORSE than the hand
shard_map transpose — the quantified justification for solver_dist
(bench/scaling_model.md)."""

import os
import sys

import numpy as np
import pytest
import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanSolver
from tpu_ocean.parallel.mesh import make_mesh
from tpu_ocean.parallel.gspmd import make_gspmd_step

CFG = OceanConfig(resolution=64, length=64.0, wind=(8.0, 5.0), amplitude=0.5,
                  spectrum_layout="fft", normals_mode="stencil")


@pytest.mark.parametrize("backend,pack", [
    ("reference", False), ("matmul", False), ("matmul", True)])
def test_gspmd_matches_single_device(backend, pack):
    solver = OceanSolver(CFG, fft_backend=backend, pack_channels=pack)
    sa = solver.init(jax.random.PRNGKey(3))
    for _ in range(3):
        sa, fa = solver.step(sa, 1 / 60)

    step, place = make_gspmd_step(solver, make_mesh(shard=8))
    sb = place(solver.init(jax.random.PRNGKey(3)))
    for _ in range(3):
        sb, fb = step(sb, 1 / 60)

    scale = float(np.abs(np.asarray(fa.height)).max())
    assert np.abs(np.asarray(fa.height)
                  - np.asarray(fb.height)).max() < 1e-5 * max(scale, 1.0)
    assert np.abs(np.asarray(fa.normal)
                  - np.asarray(fb.normal)).max() < 1e-4
    # outputs land in the contracted layout (columns sharded)
    assert fb.height.sharding.spec == jax.sharding.PartitionSpec(None, "shard")


def test_gspmd_rejects_pallas_and_real_state():
    mesh = make_mesh(shard=8)
    # the Pallas backend is gone: the solver refuses it by name
    with pytest.raises(ValueError, match="unknown fft backend"):
        OceanSolver(CFG, fft_backend="pallas")
    with pytest.raises(ValueError, match="real_state"):
        make_gspmd_step(OceanSolver(CFG, real_state=True), mesh)


def test_gspmd_collectives_strictly_worse_than_shard_map():
    """The partitioner replicates the grid around jnp.fft (one all-gather of
    the FULL 3-channel complex grid) and all-reduces partial products around
    the einsum FFT — both move ≥8× (=D×) the hand all_to_all's wire bytes.
    This is the measured reason solver_dist exists."""
    from scaling_model import (gspmd_step_hlo, hlo_collective_inventory,
                               step_collectives_model)
    n, d = 64, 8
    hand = step_collectives_model(n, d)

    ref = hlo_collective_inventory(gspmd_step_hlo(n, "reference"))
    # full grid gathered: 3 channels · N² · 8 B (complex64), no 1/D factor
    assert ref["all-gather"]["buffer_bytes"] == 3 * n * n * 8
    assert ref["all-gather"]["buffer_bytes"] \
        == d * hand["all_to_all_buffer_bytes"]

    mm = hlo_collective_inventory(gspmd_step_hlo(n, "matmul"))
    assert mm["all-reduce"]["buffer_bytes"] \
        >= d * hand["all_to_all_buffer_bytes"]

    # both rungs agree on the halo structure (6 width-1 column permutes)
    for inv in (ref, mm):
        assert inv["collective-permute"]["count"] \
            == hand["collective_permute_count"]
        assert inv["collective-permute"]["buffer_bytes"] \
            == hand["halo_wire_bytes"]

"""The bench/ tools' host-side logic on CPU: the trace reduction's scope
attribution and busy-time union (bench/trace_scopes.py), the oracle
configurations (bench/run_baselines.py) and the H100 weak-scaling
projection (bench/scaling_model.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))

import trace_scopes as ts  # noqa: E402


def test_fusion_scopes_from_compiled_hlo():
    """Every fusion of the compiled shipping step maps to the solver scopes
    of the ops inside it; the assembly shows up fused into the transform's
    input kernels and the stencils under 'fields'."""
    from tpu_ocean.config import OCEAN_DEMO
    from tpu_ocean.solver import OceanSolver, PRODUCTION
    s = OceanSolver(OCEAN_DEMO.replace(resolution=32, length=32.0),
                    **PRODUCTION)
    st = s.init(jax.random.PRNGKey(0))
    hlo = ts.fusion_scopes(s._step_jit.lower(
        st, jnp.float32(1 / 60), s._consts).compile().as_text())
    assert hlo
    seen = set().union(*hlo.values())
    assert {"spectrum_assembly", "fields", "dispersion"} <= seen
    assert all("." not in name for name in hlo)     # profiler naming
    assert ts.scope_key(frozenset({"fields", "ifft2"})) == "fields+ifft2"
    assert ts.scope_key(frozenset()) == "other"


def test_busy_ns_is_the_union_of_intervals():
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 25, "a"), (21, 22, "b")]
    assert ts.busy_ns(spans) == 20
    assert ts.busy_ns([]) == 0


def test_scope_byte_model():
    b = ts.scope_bytes(1024)
    plane = 1024 * 1024 * 4
    assert b["fields"] == 12 * plane and b["dispersion"] == 3 * plane
    assert b["spectrum_assembly"] == 12 * plane


@pytest.mark.parametrize("config", [1, 2])
def test_oracle_configs_pass_on_this_device(config):
    """Configs 1 and 2 (2 runs the FFT and the eval_mode='direct' einsum
    routes) meet their oracle tolerances on whatever device JAX picks."""
    import run_baselines as rb
    out = rb.config1() if config == 1 else rb.config2()
    for r in (out if isinstance(out, list) else [out]):
        assert r["pass"], r
        assert r["device"]["platform"] == jax.devices()[0].platform


def test_h100_projection_is_memory_and_nvlink_bound():
    """The projection keys H100 SXM with its data-sheet HBM and NVLink
    rates; one card never communicates, more cards pay the a2a."""
    import scaling_model as sm
    one = sm.project(4096, 1, pack_channels=True, half_spectrum=True)
    four = sm.project(8192, 4, pack_channels=True, half_spectrum=True)
    assert one["t_comm_us"] == 0 and one["eff_no_overlap"] == 1.0
    assert four["t_comm_us"] > 0 and 0 < four["eff_no_overlap"] < 1
    assert sm.CHIPS["H100 SXM"] == {"hbm": 3.35e12, "nvlink": 450e9}

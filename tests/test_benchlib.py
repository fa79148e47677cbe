"""benchlib unit behavior: sane per-step estimates, metadata, and the
work-consumption checksum."""

import numpy as np
import jax
import jax.numpy as jnp

from tpu_ocean.benchlib import (time_steps_meta, make_scan_stepper, _consume)


def _toy_step(state, dt, extra=None):
    new = state * jnp.float32(0.999) + dt
    return new, {"field": new * 2.0}


def test_dispatch_method_sane():
    st = jnp.ones((64, 64), jnp.float32)
    m = time_steps_meta(_toy_step, st, 0.01, k1=4, k2=32, method="dispatch")
    assert m.per_step_s > 0
    assert m.k1 == 4 and m.k2 == 32
    # grossly monotone on CPU. 0.2: microsecond-scale toy walls wobble
    # under a loaded host (the k1 burst can land on a descheduled slice);
    # the check guards ordering, not precision — flaked once at 0.5 in a
    # full parallel suite run (r5)
    assert m.wall_k2_s >= m.wall_k1_s * 0.2


def test_loop_method_and_checksum():
    st = jnp.ones((32, 32), jnp.float32)
    m = time_steps_meta(_toy_step, st, 0.01, k1=4, k2=16, method="loop")
    assert m.per_step_s > 0

    # the scan stepper's checksum must reflect every step's fields
    f4 = make_scan_stepper(_toy_step, 0.01, 4)
    f8 = make_scan_stepper(_toy_step, 0.01, 8)
    _, a4 = f4(st)
    _, a8 = f8(st)
    assert float(a8) != float(a4)


def test_consume_covers_all_leaves():
    tree = {"a": jnp.ones((2, 2)), "b": (jnp.ones(3), jnp.zeros(4))}
    assert float(_consume(tree)) == 7.0


def test_extra_args_threading():
    def step(state, dt, extra):
        return state + dt * extra["scale"], {"f": state}

    st = jnp.zeros((8, 8), jnp.float32)
    extra = {"scale": jnp.float32(2.0)}
    m = time_steps_meta(step, st, 0.5, k1=2, k2=8, method="dispatch",
                        extra=extra)
    assert m.per_step_s > 0
    m2 = time_steps_meta(step, st, 0.5, k1=2, k2=8, method="loop",
                         extra=extra)
    assert m2.per_step_s > 0


def test_ladder_flags_flat_walls_as_suspect(monkeypatch):
    """Walls that do not grow with K (work deferred past the wait, or a
    loop that does nothing) must be flagged, never trusted."""
    import time as _time
    from tpu_ocean import benchlib

    t = {"now": 0.0}
    monkeypatch.setattr(benchlib.time, "perf_counter", lambda: t["now"])

    def fake_wall_step(state, dt):
        return state, {"f": state}

    # walls advance a constant amount per run_once regardless of K
    orig_loop = benchlib.make_loop_stepper

    def fake_loop(step_impl, dt, with_extra=False):
        def run(state, k, *extra):
            t["now"] += 0.01          # constant: work deferred
            return state, jnp.zeros((), jnp.float32)
        return run

    monkeypatch.setattr(benchlib, "make_loop_stepper", fake_loop)
    lad = benchlib.time_steps_ladder(fake_wall_step,
                                     jnp.zeros((4, 4), jnp.float32), 0.01,
                                     ks=(4, 8, 16), escalate=False)
    assert lad.suspect and not lad.signal_ok


def test_ladder_escalation_reaches_signal(monkeypatch):
    """With a large dispatch constant, escalation must grow K until work
    dominates (a large per-call constant, e.g. a slow host dispatch)."""
    from tpu_ocean import benchlib

    t = {"now": 0.0}
    monkeypatch.setattr(benchlib.time, "perf_counter", lambda: t["now"])

    def fake_loop(step_impl, dt, with_extra=False):
        def run(state, k, *extra):
            t["now"] += 0.030 + 1e-5 * float(k)   # constant + real work
            return state, jnp.zeros((), jnp.float32)
        return run

    monkeypatch.setattr(benchlib, "make_loop_stepper", fake_loop)
    lad = benchlib.time_steps_ladder(lambda s, d: (s, {"f": s}),
                                     jnp.zeros((4, 4), jnp.float32), 0.01,
                                     ks=(16, 48, 128), escalate=True)
    assert not lad.suspect
    assert lad.ks[-1] > 128                  # escalated
    assert abs(lad.per_step_s - 1e-5) < 2e-6  # recovered the true slope


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR unset: the cache goes to the fixed
    <checkout>/.jax_compile_cache (the gitignored directory)."""
    import os
    from tpu_ocean import benchlib
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    set_calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.__setitem__(k, v))
    path = benchlib.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        benchlib.__file__)))
    assert path == os.path.join(root, ".jax_compile_cache")
    assert set_calls["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)


def test_compile_cache_env_var_sets_nothing(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and the program
    sets no cache directory (nor any other cache option) in code."""
    from tpu_ocean import benchlib
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    set_calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.__setitem__(k, v))
    assert benchlib.enable_compile_cache() == str(tmp_path)
    assert set_calls == {}


def test_peaks_table_keyed_by_device_kind():
    """The H100 entry carries its source; an unknown card is an error."""
    from types import SimpleNamespace
    from tpu_ocean import benchlib
    h100 = benchlib.peaks_for(SimpleNamespace(
        device_kind="NVIDIA H100 80GB HBM3"))
    assert h100["hbm_bytes_per_s"] == 3.35e12 and "data sheet" in \
        h100["source"]
    import pytest
    with pytest.raises(ValueError, match="no published peaks"):
        benchlib.peaks_for(SimpleNamespace(device_kind="cpu"))

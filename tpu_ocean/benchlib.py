"""Device step timing (host clock ending in block_until_ready) and the
persistent compilation cache.

The scheme:

  1. K solver steps run inside ONE executable (lax.fori_loop); every output
     field folds into a scalar checksum carried through the loop, so no step
     and no field is dead code.
  2. Each wall ends in block_until_ready on that checksum.
  3. Walls at a ladder of trip counts are fitted wall = intercept +
     K·per_step, which differences away the dispatch constant.
  4. Validity checks (monotone walls, small fit residual, work ≫ constant)
     flag a result ``suspect`` — reported, never silently trusted.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _consume(fields) -> jax.Array:
    """Fold every output field into one scalar so none is dead code."""
    acc = jnp.zeros((), jnp.float32)
    for leaf in jax.tree_util.tree_leaves(fields):
        acc = acc + jnp.sum(leaf).astype(jnp.float32)
    return acc


def make_scan_stepper(step_impl, dt: float, k: int, extra=None):
    """jit(state -> (state, checksum)) running ``k`` chained steps."""
    loop = make_loop_stepper(step_impl, dt, with_extra=extra is not None)
    if extra is None:
        return lambda state: loop(state, jnp.int32(k))
    return lambda state: loop(state, jnp.int32(k), extra)


def make_loop_stepper(step_impl, dt: float, with_extra: bool = False):
    """jit((state, k[, extra]) -> (state, checksum)) with a TRACED trip
    count — one compile serves every k of the ladder. ``extra`` carries the
    solver's device-resident constants as a real jit argument — closing
    over them would embed N² constants in the program."""
    dt = np.float32(dt)

    if with_extra:
        def run(state, k, extra):
            def body(_, carry):
                st, acc = carry
                st, fields = step_impl(st, dt, extra)
                return (st, acc + _consume(fields))
            return lax.fori_loop(0, k, body,
                                 (state, jnp.zeros((), jnp.float32)))
    else:
        def run(state, k):
            def body(_, carry):
                st, acc = carry
                st, fields = step_impl(st, dt)
                return (st, acc + _consume(fields))
            return lax.fori_loop(0, k, body,
                                 (state, jnp.zeros((), jnp.float32)))

    return jax.jit(run)


@dataclass
class TimingResult:
    per_step_s: float
    suspect: bool         # K-scaling self-check failed
    k1: int
    k2: int
    wall_k1_s: float
    wall_k2_s: float


@dataclass
class LadderResult:
    """K-ladder timing: walls at several trip counts from ONE compiled
    executable, a linear fit, and explicit validity checks."""
    per_step_s: float         # fitted slope
    intercept_s: float        # fitted dispatch/transfer constant
    ks: list
    walls_s: list
    monotone: bool
    max_rel_resid: float      # worst |wall − fit| / wall
    signal_ok: bool           # top wall dominated by work, not constant
    suspect: bool             # any validity check failed

    @property
    def wall_k1_s(self):
        return self.walls_s[0]

    @property
    def wall_k2_s(self):
        return self.walls_s[-1]


def time_steps_ladder(step_impl, state, dt: float, ks=(16, 48, 128),
                      repeats: int = 2, extra=None, escalate: bool = True,
                      max_k: int = 65536) -> LadderResult:
    """Differenced timing: walls at a ladder of trip counts (one fori_loop
    executable, traced count — one compile serves every K), each ending in
    block_until_ready, then a least-squares fit wall = intercept +
    K·per_step with three validity checks (monotone walls, small fit
    residual, work ≫ dispatch constant).

    With ``escalate`` the ladder is multiplied ×8 until the top wall is ≥ 3×
    the bottom one (work dominates) or ``max_k`` is reached. Escalation
    re-uses the compiled loop, so each rung costs only its own wall-clock.
    """
    import numpy as _np

    loop = make_loop_stepper(step_impl, dt, with_extra=extra is not None)
    args = () if extra is None else (extra,)

    def run_once(k):
        _, acc = loop(state, jnp.int32(k), *args)
        jax.block_until_ready(acc)

    def wall(k):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_once(k)
            best = min(best, time.perf_counter() - t0)
        return best

    ks = sorted(set(int(k) for k in ks))
    run_once(ks[0])   # compile + warm
    for attempt in range(6):
        if attempt > 0:
            # multiply BEFORE measuring so ks and walls always describe the
            # same ladder when the loop exits (by break or exhaustion)
            ks = [k * 8 for k in ks]
        walls = [wall(k) for k in ks]
        signal_ok = walls[-1] >= 3.0 * max(walls[0], 1e-9)
        if signal_ok or not escalate or ks[-1] * 8 > max_k:
            break

    ks_a = _np.asarray(ks, float)
    ws = _np.asarray(walls, float)
    slope, intercept = _np.polyfit(ks_a, ws, 1)
    pred = intercept + slope * ks_a
    # residual normalized by the TOP wall: the small rungs sit near the
    # dispatch constant where relative error is meaningless; flat ladders
    # are caught by signal_ok/monotone, not by the fit
    resid = float(_np.max(_np.abs(ws - pred)) / max(float(ws[-1]), 1e-12))
    # non-strict within 2% of the top wall: two fast rungs tying at timer
    # resolution must not null an otherwise valid ladder; genuinely flat
    # ladders are rejected by signal_ok and the fit residual
    monotone = bool(_np.all(_np.diff(ws) > -0.02 * float(ws[-1])))
    per_step = max(float(slope), 1e-9)
    suspect = not (monotone and signal_ok and resid < 0.35)
    return LadderResult(per_step_s=per_step, intercept_s=float(intercept),
                        ks=list(ks),
                        walls_s=[float(w) for w in ws], monotone=monotone,
                        max_rel_resid=resid, signal_ok=bool(signal_ok),
                        suspect=suspect)


def time_steps_meta(step_impl, state, dt: float, k1: int = 16, k2: int = 128,
                    repeats: int = 2, method: str = "dispatch",
                    extra=None) -> TimingResult:
    """TimingResult for the pure (state, dt) -> (state, fields) stepper.

    method='dispatch': chained per-step dispatches, block on the last output.
      Cheap to compile (one plain step executable); the K-linearity check
      flags walls that do not scale.
    method='loop': fori-loop-of-K executable (time_steps_ladder) — one
      dispatch per wall, so per-step dispatch overhead drops out.
    """
    if method == "dispatch":
        return _time_steps_dispatch(step_impl, state, dt, k1, k2, repeats,
                                    extra)
    # loop: a 3-rung K ladder through ONE compiled executable, fitted and
    # validity-checked (time_steps_ladder). Escalation bails out of ladders
    # whose walls are dominated by the per-call dispatch constant — the
    # regime where the old two-point differencing reported noise as signal.
    mid = max(k1 + 1, min(k2 - 1, 3 * k1))
    lad = time_steps_ladder(step_impl, state, dt, ks=(k1, mid, k2),
                            repeats=repeats, extra=extra, escalate=True)
    return TimingResult(per_step_s=lad.per_step_s,
                        suspect=lad.suspect, k1=lad.ks[0], k2=lad.ks[-1],
                        wall_k1_s=lad.wall_k1_s, wall_k2_s=lad.wall_k2_s)


def _time_steps_dispatch(step_impl, state, dt: float, k1: int, k2: int,
                         repeats: int, extra=None) -> TimingResult:
    step = jax.jit(step_impl)   # NO donation: we re-feed the same start state
    dtj = jnp.asarray(dt, jnp.float32)
    args = () if extra is None else (extra,)

    def run_k(k):
        st, fields = state, None
        for _ in range(k):
            st, fields = step(st, dtj, *args)
        jax.block_until_ready(fields)

    run_k(2)   # compile + warm
    best1 = best2 = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_k(k1)
        t1 = time.perf_counter()
        run_k(k2)
        t2 = time.perf_counter()
        best1 = min(best1, t1 - t0)
        best2 = min(best2, t2 - t1)
    per_step = max((best2 - best1) / (k2 - k1), 1e-9)
    ratio = best2 / max(best1, 1e-9)
    # suspect when walls are far off linear OR the differenced signal is in
    # the noise (work never dominated the per-call constant)
    suspect = (ratio < 0.25 * (k2 / k1)) or (best2 < 1.5 * best1)
    return TimingResult(per_step_s=per_step, suspect=suspect,
                        k1=k1, k2=k2, wall_k1_s=best1, wall_k2_s=best2)


def time_steps(step_impl, state, dt: float, k1: int = 16, k2: int = 128,
               repeats: int = 2, method: str = "dispatch") -> float:
    """Seconds per step (see time_steps_meta)."""
    return time_steps_meta(step_impl, state, dt, k1, k2, repeats,
                           method=method).per_step_s


#: the fixed cache location when JAX_COMPILATION_CACHE_DIR is unset: the
#: checkout's own (gitignored) directory. The path is part of the cache key,
#: so a fixed path is what lets a later process hit it.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_compile_cache")


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    function sets nothing. Otherwise the cache goes to the fixed
    ``<checkout>/.jax_compile_cache`` (CACHE_DIR), caching every compile
    that takes ≥ 0.5 s. Safe to call more than once."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CACHE_DIR


#: published peaks of the cards this benchmark knows, keyed by JAX's
#: ``device_kind``. A card missing here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12,
        "bf16_flops_per_s": 989e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: "
                  "3.35 TB/s HBM3, 67 TFLOP/s FP32 (non-tensor), "
                  "989 TFLOP/s BF16 dense, at the 700 W limit"},
}


def peaks_for(device) -> dict:
    """PEAKS entry of ``device``; ValueError for a card not in the table."""
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device.device_kind!r}; add it to "
                         f"benchlib.PEAKS with its source") from None


def card_info() -> str:
    """``name, power.limit`` of the card(s) from nvidia-smi, run as a child
    process that stays off JAX (a card below its 700 W limit runs slower
    under load, so every number is kept beside this line)."""
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()

"""Checkpoint / resume for solver state (SURVEY.md §5.4).

The reference loses all state on exit — everything lives in GPU textures
(OceanRenderer.cs:137-146). The full recurrent state is tiny and well-defined
(SURVEY.md C18): {h0, h0_conj, phase, t, step} + the config that produced it.
Resume is bitwise-continuing: restoring and stepping gives the same trajectory
as never having stopped (tests/test_checkpoint.py).

Format: a single .npz (atomic rename on write) holding the state leaves plus a
JSON-encoded config. Complex leaves are split into (re, im) float planes
*on device* before the host pull, so the file holds f32 planes only and
loads into either state layout (OceanState or OceanStateReal). An
Orbax-backed variant is
provided for multi-host async checkpointing of sharded state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from tpu_ocean.config import OceanConfig
from tpu_ocean.solver import OceanState

_FORMAT_VERSION = 2


def _pull(x) -> np.ndarray:
    """Device → host, splitting complex into stacked (re, im) on device."""
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        pair = jnp.stack([jnp.real(x), jnp.imag(x)])
        return np.asarray(jax.device_get(pair))
    return np.asarray(jax.device_get(x))


def _push_pair(pair) -> jnp.ndarray:
    """Upload (re, im) float planes and recombine ON DEVICE: complex64
    host↔device transfers are unreliable on the runtimes this module guards
    against (CLAUDE.md)."""
    re = jnp.asarray(pair[0], jnp.float32)
    im = jnp.asarray(pair[1], jnp.float32)
    return (re + 1j * im).astype(jnp.complex64)


def _atomic_savez(path: str, payload: dict) -> str:
    """Write ``payload`` to ``path`` (.npz appended if missing) via a
    same-directory tempfile + rename: a crash never corrupts the last good
    checkpoint. Returns the final path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _open_checkpoint(path: str):
    """np.load with the .npz suffix fallback and the version guard."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    version = int(z["version"])
    if version > _FORMAT_VERSION:
        z.close()
        raise ValueError(f"checkpoint version {version} is newer than "
                         f"supported {_FORMAT_VERSION}")
    return z


def save_checkpoint(path: str, state,
                    cfg: Optional[OceanConfig] = None) -> str:
    """Write state (+ config) to ``path`` (.npz appended if missing);
    returns the final path.

    Accepts OceanState or OceanStateReal — the wire format is identical
    (complex leaves travel as stacked (re, im) f32 pairs anyway), so real
    and complex runs share checkpoints bidirectionally."""
    from tpu_ocean.solver import OceanStateReal
    if not path.endswith(".npz"):
        path = path + ".npz"
    if isinstance(state, OceanStateReal):
        h0_pair = np.stack([_pull(state.h0_re), _pull(state.h0_im)])
        h0c_pair = np.stack([_pull(state.h0c_re), _pull(state.h0c_im)])
    else:
        h0_pair = _pull(state.h0)
        h0c_pair = _pull(state.h0_conj)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "h0_pair": h0_pair,
        "h0_conj_pair": h0c_pair,
        "phase": _pull(state.phase),
        "t": _pull(state.t),
        "step": _pull(state.step),
        "foam_accum": _pull(state.foam_accum),
    }
    if cfg is not None:
        payload["config_json"] = np.bytes_(
            json.dumps(dataclasses.asdict(cfg)).encode())
    return _atomic_savez(path, payload)


def load_checkpoint(path: str, real_state: bool = False
                    ) -> Tuple[OceanState, Optional[OceanConfig]]:
    """Read (state, config-or-None) from ``path``.

    ``real_state=True`` rebuilds an OceanStateReal DIRECTLY from the stored
    f32 plane pairs — complex64 is never formed, so a real-state solver can
    resume on runtimes whose complex support is unreliable (the wire format
    is plane pairs either way; any checkpoint restores either way)."""
    with _open_checkpoint(path) as z:
        if "kind" in z.files:
            raise ValueError(
                f"{path!r} is a {bytes(z['kind']).decode()} checkpoint "
                f"(multi-band); use load_cascade_checkpoint")
        push = _push_pair
        phase = jnp.asarray(z["phase"], jnp.float32)
        # v1 checkpoints predate foam accumulation: restore zeros
        foam_accum = (jnp.asarray(z["foam_accum"], jnp.float32)
                      if "foam_accum" in z.files
                      else jnp.zeros_like(phase))
        t = jnp.asarray(z["t"], jnp.float32)
        step = jnp.asarray(z["step"], jnp.int32)
        if real_state:
            from tpu_ocean.solver import OceanStateReal
            h0, h0c = z["h0_pair"], z["h0_conj_pair"]
            state = OceanStateReal(
                h0_re=jnp.asarray(h0[0], jnp.float32),
                h0_im=jnp.asarray(h0[1], jnp.float32),
                h0c_re=jnp.asarray(h0c[0], jnp.float32),
                h0c_im=jnp.asarray(h0c[1], jnp.float32),
                phase=phase, t=t, step=step, foam_accum=foam_accum)
        else:
            state = OceanState(
                h0=push(z["h0_pair"]),
                h0_conj=push(z["h0_conj_pair"]),
                phase=phase,
                t=t,
                step=step,
                foam_accum=foam_accum,
            )
        cfg = None
        if "config_json" in z.files:
            d = json.loads(bytes(z["config_json"]).decode())
            d["wind"] = tuple(d["wind"])
            cfg = OceanConfig(**d)
    return state, cfg


class CheckpointManager:
    """Periodic checkpointing with retention, mirroring a training loop's
    save-every-K-steps pattern. Keeps the newest ``keep`` files."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3,
                 save_fn=None, load_fn=None):
        """``save_fn(path, state, cfg)`` / ``load_fn(path)`` default to the
        OceanState pair; pass save/load_cascade_checkpoint for multi-band
        states (runtime.CascadeSimulation does)."""
        self.directory = directory
        self.interval = max(1, interval)
        self.keep = max(1, keep)
        self._save = save_fn if save_fn is not None else save_checkpoint
        self._load = load_fn if load_fn is not None else load_checkpoint
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step:010d}.npz")

    def maybe_save(self, state: OceanState,
                   cfg: Optional[OceanConfig] = None,
                   step: Optional[int] = None) -> Optional[str]:
        """Pass ``step`` when the caller tracks it host-side — pulling
        state.step forces a device sync every call."""
        if step is None:
            if hasattr(state, "frame"):        # LODState: host-side counter
                step = int(state.frame)
            else:
                step = int(jax.device_get(state.step))
        if step % self.interval != 0:
            return None
        p = self._path(step)
        self._save(p, state, cfg)
        self._gc()
        return p

    def _gc(self):
        ckpts = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("state_") and f.endswith(".npz"))
        for f in ckpts[: -self.keep]:
            os.unlink(os.path.join(self.directory, f))

    def latest(self) -> Optional[str]:
        ckpts = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("state_") and f.endswith(".npz"))
        return os.path.join(self.directory, ckpts[-1]) if ckpts else None

    def restore_latest(self):
        p = self.latest()
        if p is None:
            return None, None
        return self._load(p)


# ---------------------------------------------------------------- orbax path

def _orbax_tree(state) -> dict:
    """The orbax wire tree: the same all-f32 plane pairs as the npz format,
    so both checkpoint families interoperate across representations. Sharded
    leaves stay sharded — each process writes only its addressable shards
    (orbax's distributed save; SURVEY §5.4 / roadmap #12)."""
    from tpu_ocean.solver import OceanStateReal
    if isinstance(state, OceanStateReal):
        planes = {"h0_re": state.h0_re, "h0_im": state.h0_im,
                  "h0c_re": state.h0c_re, "h0c_im": state.h0c_im}
    else:
        planes = {"h0_re": jnp.real(state.h0), "h0_im": jnp.imag(state.h0),
                  "h0c_re": jnp.real(state.h0_conj),
                  "h0c_im": jnp.imag(state.h0_conj)}
    planes.update(phase=state.phase, t=state.t, step=state.step,
                  foam_accum=state.foam_accum)
    return planes


def save_checkpoint_orbax(directory: str, state) -> None:
    """Async-capable SHARDED checkpoint via Orbax (multi-host fleets): every
    process calls this collectively; each writes only the shards it owns.
    Accepts OceanState or OceanStateReal (wire format identical — plane
    pairs). The .npz path above stays the single-host default: it has no
    daemon, no directory protocol, and restores anywhere."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(directory), _orbax_tree(state), force=True)
    ckptr.wait_until_finished()


def load_checkpoint_orbax(directory: str, like=None):
    """Restore an orbax checkpoint.

    ``like`` (a state pytree, e.g. ``solver.init(...)`` on the SAME mesh —
    either representation) makes the restore SHARDED: each leaf is read
    directly into ``like``'s sharding, so a multi-process fleet resumes
    without ever materializing the global state on one host, and an
    OceanStateReal ``like`` keeps the restore complex-free. Without it,
    the legacy single-host behavior: a replicated complex OceanState."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    path = os.path.abspath(directory)
    if like is not None:
        from tpu_ocean.solver import OceanStateReal
        target = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                           sharding=x.sharding),
            _orbax_tree(like))
        try:
            d = ckptr.restore(path, target)
        except Exception:
            # pre-foam_accum checkpoint: the stored tree lacks the leaf,
            # so a target that demands it fails — retry without it and
            # zero-fill under `like`'s sharding (the legacy loader below
            # and the npz path already do this; the SHARDED path must not
            # be the one place old checkpoints break — review finding, r5)
            slim = {k: v for k, v in target.items() if k != "foam_accum"}
            d = ckptr.restore(path, slim)
            d["foam_accum"] = jax.jit(
                lambda: jnp.zeros(like.foam_accum.shape, jnp.float32),
                out_shardings=like.foam_accum.sharding)()
        common = dict(phase=d["phase"], t=d["t"], step=d["step"],
                      foam_accum=d["foam_accum"])
        if isinstance(like, OceanStateReal):
            return OceanStateReal(h0_re=d["h0_re"], h0_im=d["h0_im"],
                                  h0c_re=d["h0c_re"], h0c_im=d["h0c_im"],
                                  **common)
        # recombine per-shard on device under the same sharding as `like`
        tie = jax.jit(lambda re, im: (re + 1j * im).astype(jnp.complex64),
                      out_shardings=like.h0.sharding)
        return OceanState(h0=tie(d["h0_re"], d["h0_im"]),
                          h0_conj=tie(d["h0c_re"], d["h0c_im"]), **common)
    d = ckptr.restore(path)

    def push(re, im):   # combine on device (complex host↔device is fragile)
        return (jnp.asarray(re, jnp.float32)
                + 1j * jnp.asarray(im, jnp.float32)).astype(jnp.complex64)

    phase = jnp.asarray(d["phase"], jnp.float32)
    return OceanState(
        h0=push(d["h0_re"], d["h0_im"]),
        h0_conj=push(d["h0c_re"], d["h0c_im"]),
        phase=phase,
        t=jnp.asarray(d["t"], jnp.float32),
        step=jnp.asarray(d["step"], jnp.int32),
        foam_accum=(jnp.asarray(d["foam_accum"], jnp.float32)
                    if "foam_accum" in d else jnp.zeros_like(phase)),
    )


# ------------------------------------------------------- cascade / LOD states

def save_cascade_checkpoint(path: str, state, cfgs=None,
                            periods=None) -> None:
    """Checkpoint a CascadeState or LODState (lod.py) — the multi-band
    analogue of save_checkpoint. Same format discipline: atomic .npz, complex
    split to (re, im) planes on device before the pull, band configs stored
    as a JSON list. ``periods`` (the LOD refresh schedule) is stored so a
    resume under a DIFFERENT schedule can be refused — restored phases are
    only meaningful relative to the schedule that wrote them.
    """
    from tpu_ocean.lod import LODState
    from tpu_ocean.cascade import CascadeStateReal

    is_lod = isinstance(state, LODState)
    cst = state.cascade if is_lod else state
    if isinstance(cst, CascadeStateReal):
        # same wire format as the complex state (plane pairs)
        h0_pair = np.stack([_pull(cst.h0_re), _pull(cst.h0_im)])
        h0c_pair = np.stack([_pull(cst.h0c_re), _pull(cst.h0c_im)])
    else:
        h0_pair = _pull(cst.h0)
        h0c_pair = _pull(cst.h0_conj)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "kind": np.bytes_(b"lod" if is_lod else b"cascade"),
        "h0_pair": h0_pair,
        "h0_conj_pair": h0c_pair,
        "phase": _pull(cst.phase),
        "t": _pull(cst.t),
        "step": _pull(cst.step),
    }
    if is_lod:
        payload["planes"] = _pull(state.planes)
        payload["frame"] = np.int64(state.frame)   # host-side by design
    if periods is not None:
        payload["periods"] = np.asarray(periods, np.int64)
    if cfgs is not None:
        payload["configs_json"] = np.bytes_(json.dumps(
            [dataclasses.asdict(c) for c in cfgs]).encode())
    _atomic_savez(path, payload)


def load_cascade_checkpoint(path: str, real_state: bool = False):
    """Read (CascadeState-or-LODState, [OceanConfig]-or-None).

    ``real_state=True`` rebuilds CascadeStateReal straight from the stored
    f32 plane pairs — complex64 never formed (same contract as
    load_checkpoint)."""
    from tpu_ocean.cascade import CascadeState, CascadeStateReal
    from tpu_ocean.lod import LODState

    with _open_checkpoint(path) as z:
        if "kind" not in z.files:
            raise ValueError(
                f"{path!r} is a single-patch checkpoint; "
                f"use load_checkpoint")
        phase = jnp.asarray(z["phase"], jnp.float32)
        t = jnp.asarray(z["t"], jnp.float32)
        step = jnp.asarray(z["step"], jnp.int32)
        if real_state:
            h0, h0c = z["h0_pair"], z["h0_conj_pair"]
            cst = CascadeStateReal(
                h0_re=jnp.asarray(h0[0], jnp.float32),
                h0_im=jnp.asarray(h0[1], jnp.float32),
                h0c_re=jnp.asarray(h0c[0], jnp.float32),
                h0c_im=jnp.asarray(h0c[1], jnp.float32),
                phase=phase, t=t, step=step)
        else:
            cst = CascadeState(
                h0=_push_pair(z["h0_pair"]),
                h0_conj=_push_pair(z["h0_conj_pair"]),
                phase=phase,
                t=t,
                step=step,
            )
        if bytes(z["kind"]).decode() == "lod":
            state = LODState(cascade=cst,
                             planes=jnp.asarray(z["planes"], jnp.float32),
                             frame=int(z["frame"]))
        else:
            state = cst
        cfgs = None
        if "configs_json" in z.files:
            ds = json.loads(bytes(z["configs_json"]).decode())
            for d in ds:
                d["wind"] = tuple(d["wind"])
            cfgs = [OceanConfig(**d) for d in ds]
    return state, cfgs


def cascade_checkpoint_periods(path: str):
    """The LOD refresh schedule a cascade checkpoint was written under, or
    None for plain cascades / pre-schedule files. Cheap metadata peek (no
    state upload) for resume validation (runtime.CascadeSimulation)."""
    with _open_checkpoint(path) as z:
        if "periods" in z.files:
            return [int(p) for p in z["periods"]]
    return None

"""Domain-decomposed ocean solver over a jax.sharding.Mesh (D1-D6).

One shard_map'ped, jitted step: spectrum assembly on X-sharded state, the
all_to_all 2-D IFFT (fft.distributed), then Z-sharded field extraction with
ppermute halo rings for the stencils. Semantically identical to
solver.OceanSolver — test_distributed.py asserts shard-exact agreement with
the single-device step (SURVEY.md §4.3).

Sharding layout (axis name 'shard'):
    state.h0 / h0_conj / phase : P('shard', None)   — rows (X) split
    fields.*                   : P(None, 'shard')   — columns (Z) split
An optional leading ensemble axis (D2) can be added by vmapping init/step and
meshing ('batch', 'shard'); the core step is written for one patch.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpu_ocean.config import OceanConfig
from tpu_ocean import grids
from tpu_ocean.evolve import omega_grid, spectrum_coefficients, assemble_spectra
from tpu_ocean.spectra import h0_pair_centered, h0_pair_fft
from tpu_ocean.fft import check_backend
from tpu_ocean.fft.distributed import ifft2_x_sharded, ifft2_x_sharded_half
from tpu_ocean.fft.reference import centered_modulation
from tpu_ocean import fields as field_ops
from tpu_ocean.parallel.halo import make_roll_fn
from tpu_ocean.solver import OceanState, OceanStateReal, OceanFields


class DistributedOceanSolver:
    """Sharded twin of OceanSolver. ``mesh`` must contain a 'shard' axis."""

    def __init__(self, cfg: OceanConfig, mesh: Mesh,
                 fft_backend: str = "reference", overlap_chunks: int = 1,
                 real_state: bool = False,
                 pack_channels: Optional[bool] = None,
                 half_spectrum: bool = False):
        if "shard" not in mesh.axis_names:
            raise ValueError("mesh needs a 'shard' axis (parallel.make_mesh)")
        check_backend(fft_backend)
        # all-real sharded step: state, spectra and a2a transposes move
        # (re, im) f32 planes, like OceanSolver(real_state=True); same
        # backend/layout constraints as the single-device twin
        if real_state:
            if fft_backend != "reference":
                raise ValueError("real_state runs the plane transforms of "
                                 "fft.reference; use fft_backend='reference'")
            if cfg.spectrum_layout != "fft":
                raise ValueError("real_state requires spectrum_layout='fft'")
        self.real_state = real_state
        n = cfg.resolution
        n_dev = mesh.shape["shard"]
        if n % n_dev != 0:
            raise ValueError(f"resolution {n} not divisible by shard={n_dev}")
        self.cfg = cfg
        self.mesh = mesh
        self.fft_backend = fft_backend
        self._precision = cfg.precision
        # stencil normals never read the slope spectra: transform only 3
        # channels (see OceanSolver._nch); here it also cuts the a2a volume
        # 40%
        self._nch = 3 if cfg.normals_mode == "stencil" else 5
        # Hermitian channel packing (evolve.packed_coefficients), same
        # DEFAULT-OFF rule as OceanSolver (parity ledger) — shard-exact
        # parity with the single-device step requires BOTH solvers to pack
        # identically. Here packing also cuts the a2a transpose volume by
        # the same third.
        can_pack = cfg.spectrum_layout == "fft"
        if pack_channels is None:
            pack_channels = False
        elif pack_channels and not can_pack:
            raise ValueError("pack_channels requires spectrum_layout='fft'")
        self.pack_channels = bool(pack_channels)
        #: channels actually transformed / transposed (= _nch unless packed)
        self._pch = ((2 if self._nch == 3 else 3) if self.pack_channels
                     else self._nch)
        # Half-spectrum (C2R) route for the last packed channel, sharded:
        # fft.distributed.ifft2_x_sharded_half (mirror-balanced — every
        # device transforms N/(2D) rows, the a2a moves half that channel's
        # volume). Same flag constraints as OceanSolver, plus the mesh/row
        # divisibility the mirror scheme needs.
        if half_spectrum:
            if not self.pack_channels:
                raise ValueError("half_spectrum rides the last PACKED "
                                 "channel's Hermitian structure — it "
                                 "requires pack_channels=True")
            if fft_backend != "reference":
                raise ValueError("half_spectrum runs the C2R transform of "
                                 "fft.reference; use fft_backend='reference'")
            if n % 2 or (n_dev > 1 and (n_dev % 2 or n % (2 * n_dev))):
                raise ValueError(
                    f"half_spectrum's mirror-balanced sharding needs an "
                    f"even N and, on more than one device, an EVEN shard "
                    f"count D with N divisible by 2D (got D={n_dev}, N={n}) "
                    f"— see ifft2_x_sharded_half")
        self.half_spectrum = bool(half_spectrum)
        # >1 splits the channel batch so the all_to_all transpose of one
        # chunk overlaps the row transforms of the next (SURVEY.md §5.8)
        if overlap_chunks > 1:
            if self._pch % overlap_chunks != 0:
                raise ValueError(f"overlap_chunks must divide the "
                                 f"{self._pch}-channel transform batch (got "
                                 f"{overlap_chunks}); use 1 or {self._pch}")
        self.overlap_chunks = overlap_chunks
        self.n_local = n // n_dev

        # trace-time constants (full-size; shard_map slices them via
        # in_specs). All REAL f32 device arrays passed as step arguments;
        # the complex modulation factors split into (re, im) pairs.
        self._omega = jnp.asarray(np.asarray(omega_grid(cfg), np.float32))
        if self.pack_channels:
            from tpu_ocean.evolve import packed_coefficients
            # stacked [2P, N, N]: rows 0..P−1 = A, P..2P−1 = B (P = A − iB)
            self._coeffs = jnp.asarray(
                np.asarray(packed_coefficients(cfg, self._nch), np.float32))
        else:
            self._coeffs = jnp.asarray(
                np.asarray(spectrum_coefficients(cfg).real,
                           np.float32)[:self._nch])
        if cfg.spectrum_layout == "centered":
            pre, post = centered_modulation(n, cfg.length, cfg.unit_width)
            x1d = grids.coordinate_1d(n, cfg.unit_width)
        else:
            pre = np.ones((n, n), np.complex64)
            post = np.ones((n, n), np.complex64)
            x1d = np.arange(n, dtype=np.float64) * (cfg.length / n)
        self._pre_re = jnp.asarray(np.asarray(pre.real, np.float32))
        self._pre_im = jnp.asarray(np.asarray(pre.imag, np.float32))
        self._post_re = jnp.asarray(np.asarray(post.real, np.float32))
        self._post_im = jnp.asarray(np.asarray(post.imag, np.float32))
        x0, z0 = np.meshgrid(x1d, x1d, indexing="ij")
        self._x0 = jnp.asarray(x0, jnp.float32)
        self._z0 = jnp.asarray(z0, jnp.float32)

        x_spec = P("shard", None)      # state layout: rows split
        z_spec = P(None, "shard")      # field layout: columns split
        if real_state:
            state_specs = OceanStateReal(
                h0_re=x_spec, h0_im=x_spec, h0c_re=x_spec, h0c_im=x_spec,
                phase=x_spec, t=P(), step=P(), foam_accum=z_spec)
        else:
            state_specs = OceanState(h0=x_spec, h0_conj=x_spec, phase=x_spec,
                                     t=P(), step=P(),
                                     # foam accumulates in the fields'
                                     # (Z-sharded) orientation — it
                                     # feeds/consumes them
                                     foam_accum=z_spec)
        self._state_specs = state_specs
        self._x_spec, self._z_spec = x_spec, z_spec
        self._velocity_jit = None      # built lazily (serve hot path)
        field_specs = OceanFields(
            height=z_spec, disp_x=z_spec, disp_z=z_spec,
            pos_x=z_spec, pos_z=z_spec, normal=P(None, "shard", None),
            foam=z_spec, jacobian=z_spec)

        sharded_step = shard_map(
            self._step_local,
            mesh=mesh,
            in_specs=(state_specs, P(),            # state, dt
                      x_spec, P(None, "shard", None),  # omega, coeffs [C,N,N]
                      x_spec, x_spec,              # pre re/im (X-sharded)
                      z_spec, z_spec,              # post re/im (Z-sharded)
                      z_spec, z_spec),             # x0, z0
            out_specs=(state_specs, field_specs),
        )
        # exposed for DP×SP composition (ensemble.EnsembleDistributedSolver
        # vmaps this over a leading member axis); vma checking cannot span
        # the vmap's spmd batch axis, so the composition twin disables it
        self._sharded_step = shard_map(
            self._step_local, mesh=mesh,
            in_specs=(state_specs, P(), x_spec, P(None, "shard", None),
                      x_spec, x_spec, z_spec, z_spec, z_spec, z_spec),
            out_specs=(state_specs, field_specs), check_vma=False)
        self._step_jit = jax.jit(sharded_step, donate_argnums=(0,))

    # -------------------------------------------------------------- init

    def symmetrize(self, state):
        """Hermitian projection of the h0 pair when packing (the exact twin
        of OceanSolver.symmetrize — see its docstring for the derivation,
        the f32-rounding parity argument, and the bitwise idempotence that
        makes applying it to resumed checkpoints safe)."""
        if not self.pack_channels:
            return state
        from tpu_ocean.evolve import hermitize_pair, hermitize_planes
        if isinstance(state, OceanStateReal):
            ar, ai, acr, aci = hermitize_planes(
                state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            return state._replace(h0_re=ar, h0_im=ai, h0c_re=acr, h0c_im=aci)
        a, ac = hermitize_pair(state.h0, state.h0_conj)
        return state._replace(h0=a, h0_conj=ac)

    def init(self, key: Optional[jax.Array] = None,
             h0: Optional[jax.Array] = None,
             h0_conj: Optional[jax.Array] = None):
        cfg = self.cfg
        n = cfg.resolution
        x_sh = NamedSharding(self.mesh, P("shard", None))
        z_sh = NamedSharding(self.mesh, P(None, "shard"))
        rep = NamedSharding(self.mesh, P())
        if self.real_state:
            # plane init (as OceanSolver.init): sample h0 directly as
            # (re, im) planes — bit-identical draw to h0_pair_fft — or split
            # an injected complex pair (parity tests). Planes shard like h0.
            if h0 is None:
                from tpu_ocean.spectra import h0_pair_fft_planes
                if key is None:
                    key = jax.random.PRNGKey(cfg.seed)
                r1, i1, r2, i2 = h0_pair_fft_planes(
                    key, n, cfg.length, cfg.phillips_amplitude, cfg.wind,
                    cfg.damping, model=cfg.spectrum_model,
                    jonswap_kw=cfg.jonswap_kw)
            else:
                h0 = jnp.asarray(h0, jnp.complex64)
                h0_conj = jnp.asarray(h0_conj, jnp.complex64)
                r1 = jnp.real(h0).astype(jnp.float32)
                i1 = jnp.imag(h0).astype(jnp.float32)
                r2 = jnp.real(h0_conj).astype(jnp.float32)
                i2 = jnp.imag(h0_conj).astype(jnp.float32)
            if self.pack_channels:
                from tpu_ocean.evolve import hermitize_planes
                r1, i1, r2, i2 = hermitize_planes(r1, i1, r2, i2)
            return OceanStateReal(
                h0_re=jax.device_put(r1, x_sh),
                h0_im=jax.device_put(i1, x_sh),
                h0c_re=jax.device_put(r2, x_sh),
                h0c_im=jax.device_put(i2, x_sh),
                phase=jax.device_put(jnp.zeros((n, n), jnp.float32), x_sh),
                t=jax.device_put(jnp.zeros((), jnp.float32), rep),
                step=jax.device_put(jnp.zeros((), jnp.int32), rep),
                foam_accum=jax.device_put(jnp.zeros((n, n), jnp.float32),
                                          z_sh),
            )
        if h0 is None:
            if key is None:
                key = jax.random.PRNGKey(cfg.seed)
            pair_fn = (h0_pair_centered if cfg.spectrum_layout == "centered"
                       else h0_pair_fft)
            h0, h0_conj = pair_fn(key, n, cfg.length, cfg.phillips_amplitude,
                                  cfg.wind, cfg.damping,
                                  model=cfg.spectrum_model,
                                  jonswap_kw=cfg.jonswap_kw)
        if self.pack_channels:
            # hermitize BEFORE sharding: negflip's reversed roll would
            # otherwise trigger resharding collectives on the fresh arrays
            from tpu_ocean.evolve import hermitize_pair
            h0, h0_conj = hermitize_pair(jnp.asarray(h0, jnp.complex64),
                                         jnp.asarray(h0_conj, jnp.complex64))
        return OceanState(
            h0=jax.device_put(jnp.asarray(h0, jnp.complex64), x_sh),
            h0_conj=jax.device_put(jnp.asarray(h0_conj, jnp.complex64), x_sh),
            phase=jax.device_put(jnp.zeros((n, n), jnp.float32), x_sh),
            t=jax.device_put(jnp.zeros((), jnp.float32), rep),
            step=jax.device_put(jnp.zeros((), jnp.int32), rep),
            # foam accumulates in the fields' (Z-sharded) orientation
            foam_accum=jax.device_put(jnp.zeros((n, n), jnp.float32), z_sh),
        )

    def shard_state(self, state):
        """device_put a host/unsharded state pytree onto this solver's mesh
        layout — the checkpoint-resume entry point (checkpoint.load_checkpoint
        returns host arrays; pass real_state=True there to get the
        OceanStateReal view this solver's real mode consumes)."""
        if isinstance(state, OceanStateReal) != self.real_state:
            raise ValueError("state representation does not match the "
                             "solver's real_state setting (load_checkpoint"
                             "(real_state=...) selects the view)")
        return jax.tree.map(
            lambda v, spec: jax.device_put(
                jnp.asarray(v), NamedSharding(self.mesh, spec)),
            state, self._state_specs)

    def reconfigure(self, state: OceanState, new_cfg: OceanConfig,
                    key=None):
        """Live parameter change (mirrors OceanSolver.reconfigure): new
        spectrum, phase preserved when the grid/layout is unchanged.
        Init-only changes (wind/amplitude/spectrum shape/seed) REUSE the
        compiled shard_map step — no retrace, no multi-device recompile —
        exactly the single-device fast path; everything else rebuilds."""
        from tpu_ocean.solver import OceanSolver
        import dataclasses
        changed = {f.name for f in dataclasses.fields(new_cfg)
                   if getattr(new_cfg, f.name) != getattr(self.cfg, f.name)}
        if changed <= OceanSolver._INIT_ONLY_FIELDS:
            import copy
            solver = copy.copy(self)   # shares _step_jit + trace constants
            solver.cfg = new_cfg
            fresh = solver.init(key if key is not None
                                else jax.random.PRNGKey(new_cfg.seed))
            return solver, fresh._replace(phase=state.phase, t=state.t,
                                          step=state.step,
                                          foam_accum=state.foam_accum)
        solver = DistributedOceanSolver(new_cfg, self.mesh,
                                        fft_backend=self.fft_backend,
                                        overlap_chunks=self.overlap_chunks,
                                        real_state=self.real_state,
                                        pack_channels=(self.pack_channels
                                                       if new_cfg.spectrum_layout
                                                       == self.cfg.spectrum_layout
                                                       else None),
                                        half_spectrum=(
                                            self.half_spectrum
                                            if new_cfg.spectrum_layout
                                            == self.cfg.spectrum_layout
                                            else False))
        fresh = solver.init(key if key is not None
                            else jax.random.PRNGKey(new_cfg.seed))
        if (new_cfg.resolution == self.cfg.resolution
                and new_cfg.spectrum_layout == self.cfg.spectrum_layout):
            fresh = fresh._replace(phase=state.phase, t=state.t,
                                   step=state.step,
                                   foam_accum=state.foam_accum)
        return solver, fresh

    def step(self, state, dt: float = 1.0 / 60.0):
        return self._step_jit(state, jnp.asarray(dt, jnp.float32),
                              self._omega, self._coeffs,
                              self._pre_re, self._pre_im,
                              self._post_re, self._post_im,
                              self._x0, self._z0)

    def velocity(self, state, t: Optional[float] = None) -> jax.Array:
        """Distributed ∂h/∂t [N, N] (Z-sharded, like the fields) — the
        sharded twin of OceanSolver.velocity (VERDICT r3 #3: the serving /
        coupling output existed on every solver except this one). The
        iω-weighted spectrum algebra runs X-sharded and ALL-REAL
        (solver._velocity_real_impl's plane expansion), then the transform
        rides the same a2a decomposition as the step (the mirror-balanced
        C2R route with half_spectrum). Cached jitted shard_map: one trace
        per solver (serving hot path, ADVICE r2)."""
        if self.cfg.evolution_mode == "absolute":
            tt = state.t if t is None else jnp.asarray(t, jnp.float32)
        else:
            if t is not None:
                raise ValueError("phase mode accumulates incrementally: "
                                 "velocity is defined at the state's "
                                 "current phase (pass no t)")
            tt = state.t            # unused by the phase-mode closure
        if self._velocity_jit is None:
            fn = shard_map(self._velocity_local, mesh=self.mesh,
                           in_specs=(self._state_specs, P(), self._x_spec,
                                     self._x_spec, self._x_spec,
                                     self._z_spec, self._z_spec),
                           out_specs=self._z_spec)
            self._velocity_jit = jax.jit(fn)
        return self._velocity_jit(state, tt, self._omega,
                                  self._pre_re, self._pre_im,
                                  self._post_re, self._post_im)

    def _velocity_local(self, state, tt, omega,
                        pre_re, pre_im, post_re, post_im):
        """Per-shard body of ``velocity``: ∂ₜh̃ planes on the local X rows,
        distributed transform, Re plane out ([X, N/D] per shard)."""
        cfg = self.cfg
        if cfg.evolution_mode == "absolute":
            phase = omega * tt
        else:
            phase = state.phase
        # phase mode advances φ by ω·dt·dt_multiplier per wall dt, so ∂h/∂t
        # carries that factor (see OceanSolver.velocity)
        rate = np.float32(cfg.dt_multiplier
                          if cfg.evolution_mode == "phase" else 1.0)
        if isinstance(state, OceanStateReal):
            a, b = state.h0_re, state.h0_im
            cc, d = state.h0c_re, state.h0c_im
        else:
            a, b = jnp.real(state.h0), jnp.imag(state.h0)
            cc, d = jnp.real(state.h0_conj), jnp.imag(state.h0_conj)
        cph = jnp.cos(phase)
        sph = jnp.sin(phase)
        # h0·e^{iφ} − h0*·e^{−iφ}, expanded; v_spec = i·rate·ω·(…)
        diff_re = (a - cc) * cph - (b + d) * sph
        diff_im = (b - d) * cph + (a + cc) * sph
        w = rate * omega
        vr, vi = -(w * diff_im), w * diff_re
        if self.half_spectrum:
            # v̂ is exactly Hermitian under the packed projection (the same
            # symmetry the step's half channel rides), so the serving
            # velocity plane gets the mirror-balanced sharded C2R — half
            # the transform rows AND half the a2a volume
            return ifft2_x_sharded_half(vr[None], vi[None], "shard")[0]
        vspec = lax.complex(vr, vi)[None]
        if cfg.spectrum_layout == "centered":
            vspec = vspec * (pre_re + 1j * pre_im)[None]
        out = ifft2_x_sharded(vspec, "shard", self.fft_backend,
                              precision=self._precision)
        if cfg.spectrum_layout == "centered":
            out = out * (post_re + 1j * post_im)[None]
        return jnp.real(out[0])

    # ------------------------------------------------------ per-shard body

    def _step_local(self, state, dt, omega, coeffs,
                    pre_re, pre_im, post_re, post_im, x0, z0):
        cfg = self.cfg

        # --- evolution (X-sharded, pure elementwise: no comm) ---
        if cfg.evolution_mode == "absolute":
            t_new = state.t + dt / cfg.t_division
            phase = omega * t_new
            phase_state = state.phase
        else:
            from tpu_ocean.evolve import evolve_phase_accumulate
            phase = evolve_phase_accumulate(state.phase, omega,
                                            dt * cfg.dt_multiplier)
            phase_state = phase
            t_new = state.t + dt

        # --- distributed transform: X-sharded in, Z-sharded out ---
        if isinstance(state, OceanStateReal):
            # all-real pipeline: the assembly and state stay (re, im) f32
            # planes; the a2a transposes move f32 planes either way
            pair = (state.h0_re, state.h0_im, state.h0c_re, state.h0c_im)
            if self.pack_channels:
                from tpu_ocean.evolve import assemble_spectra_packed_real
                re, im = assemble_spectra_packed_real(pair, phase, coeffs)
            else:
                from tpu_ocean.evolve import assemble_spectra_real
                re, im = assemble_spectra_real(pair, phase, coeffs)
            spectra = lax.complex(re, im)
        elif self.pack_channels:
            from tpu_ocean.evolve import assemble_spectra_packed
            spectra = assemble_spectra_packed(state.h0, state.h0_conj,
                                              phase, coeffs)
        else:
            spectra = assemble_spectra(state.h0, state.h0_conj, phase,
                                       coeffs)
        if cfg.spectrum_layout == "centered":
            spectra = spectra * (pre_re + 1j * pre_im)[None]
        half = None
        oc = self.overlap_chunks
        if self.half_spectrum:
            last = spectra[-1:]
            half = ifft2_x_sharded_half(jnp.real(last), jnp.imag(last),
                                        "shard")[0]          # [X, N/D] real
            spectra = spectra[:-1]
            # the half channel is its own launch group, so chunking applies
            # to the remaining full channels only
            oc = oc if spectra.shape[0] % oc == 0 else 1
        f = ifft2_x_sharded(spectra, "shard", self.fft_backend,
                            overlap_chunks=oc, precision=self._precision)
        if cfg.spectrum_layout == "centered":
            f = f * (post_re + 1j * post_im)[None]
        re, im = jnp.real(f), jnp.imag(f)
        if self.pack_channels:
            # packed channels: fields alternate Re/Im down the packed list;
            # the half route's real plane is the last packed field
            nch5 = self._nch == 5
            height, disp_x = re[0], im[0]
            if half is not None:
                disp_z = re[1] if nch5 else half
                slope_z = half if nch5 else None
            else:
                disp_z = re[1]
                slope_z = re[2] if nch5 else None
            slope_x = im[1] if nch5 else None
        else:
            height, disp_x, disp_z = re[0], im[1], im[2]
            slope_x = im[3] if self._nch == 5 else None
            slope_z = im[4] if self._nch == 5 else None

        # --- field extraction (Z-sharded; stencils ride the halo ring) ---
        roll = make_roll_fn("shard", sharded_axes=(1,))
        chop = cfg.choppiness

        z_off = lax.axis_index("shard") * self.n_local
        if cfg.normals_mode == "spectral":
            normal = field_ops.normals_spectral(slope_x, slope_z)
        else:
            normal = field_ops.normals_stencil(
                chop * disp_x, height, chop * disp_z,
                cfg.length / cfg.resolution, roll_fn=roll)
        if cfg.spectrum_layout == "centered":
            foam, jac = field_ops.whitecap_oracle(
                disp_x, disp_z, normal, roll_fn=roll,
                axis_offsets=(0, z_off),
                global_sizes=(cfg.resolution, cfg.resolution))
        else:
            foam, jac = field_ops.whitecap_gpu(
                chop * disp_x, chop * disp_z, normal, roll_fn=roll)

        foam_accum = state.foam_accum
        if cfg.foam_decay > 0.0:
            foam_accum = jnp.maximum(
                foam, state.foam_accum
                * jnp.exp(-np.float32(cfg.foam_decay) * dt))
            foam = foam_accum

        if isinstance(state, OceanStateReal):
            new_state = OceanStateReal(
                h0_re=state.h0_re, h0_im=state.h0_im,
                h0c_re=state.h0c_re, h0c_im=state.h0c_im,
                phase=phase_state, t=t_new, step=state.step + 1,
                foam_accum=foam_accum)
        else:
            new_state = OceanState(h0=state.h0, h0_conj=state.h0_conj,
                                   phase=phase_state, t=t_new,
                                   step=state.step + 1,
                                   foam_accum=foam_accum)
        out = OceanFields(height=height, disp_x=disp_x, disp_z=disp_z,
                          pos_x=x0 - chop * disp_x, pos_z=z0 - chop * disp_z,
                          normal=normal, foam=foam, jacobian=jac)
        return new_state, out

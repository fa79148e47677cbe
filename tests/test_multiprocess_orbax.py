"""Orbax SHARDED checkpointing across a REAL 2-process gloo fleet
(SURVEY.md §5.4, roadmap #12, VERDICT r3 #4): every process collectively
saves only the shards it owns; one process is killed mid-run; the relaunched
fleet restores each shard directly into its sharding (no single-host gather)
and finishes with exactly the checksum of an uninterrupted run.

Composes tests/test_multiprocess_fault.py's kill/relaunch protocol with the
checkpoint.save_checkpoint_orbax / load_checkpoint_orbax(like=...) path —
the REAL-STATE solver, so the restored multi-chip program is complex-free.
"""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); port = sys.argv[2]
    ckpt = sys.argv[3]; total = int(sys.argv[4])
    die_at = int(sys.argv[5])         # -1 = never
    jax.distributed.initialize(f"localhost:{port}", 2, pid)
    import numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tpu_ocean.config import OceanConfig
    from tpu_ocean.solver_dist import DistributedOceanSolver
    from tpu_ocean.checkpoint import (save_checkpoint_orbax,
                                      load_checkpoint_orbax)

    devs = np.asarray(jax.devices()).reshape(1, -1)
    mesh = Mesh(devs, ("batch", "shard"))
    cfg = OceanConfig(resolution=32, length=32.0, wind=(6.0, 4.0),
                      amplitude=0.1, evolution_mode="phase",
                      dispersion_mode="capillary", spectrum_layout="fft",
                      normals_mode="stencil")
    solver = DistributedOceanSolver(cfg, mesh,
                                    real_state=True)

    st = solver.init(jax.random.PRNGKey(7))
    start = 0
    if os.path.isdir(ckpt):
        # SHARDED restore: each process reads straight into the shardings
        # of its own init state — the global state never lands on one host
        st = load_checkpoint_orbax(ckpt, like=st)
        start = int(np.asarray(jax.device_get(st.step)))

    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda x: x, out_shardings=rep)

    for k in range(start, total):
        st, f = solver.step(st, 1 / 60)
        jax.block_until_ready(f.height)
        save_checkpoint_orbax(ckpt, st)   # collective: both processes call
        print(f"STEP {k + 1}", flush=True)
        if pid == 1 and die_at >= 0 and k + 1 == die_at:
            os._exit(17)              # simulated host failure

    s = float(jnp.sum(jnp.abs(gather(f.height))))
    print(f"CHECKSUM {s:.6f}", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(ckpt, total, die_at):
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, ckpt, str(total),
         str(die_at)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for i in range(2)]


def _finish(procs, timeout=300):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        outs.append((p.returncode, out, err))
    return outs


def test_orbax_sharded_fleet_kill_relaunch_resume(tmp_path):
    ckpt = str(tmp_path / "orbax_fleet")
    total = 6

    # ground truth: uninterrupted 2-process run
    truth = _finish(_launch(str(tmp_path / "orbax_truth"), total, -1))
    assert all(rc == 0 for rc, _, _ in truth), truth[0][2][-800:]
    want = [l.split()[1] for rc, o, _ in truth for l in o.splitlines()
            if l.startswith("CHECKSUM")][0]

    # run 1: process 1 dies after step 3; supervisor tears down the survivor
    procs = _launch(ckpt, total, die_at=3)
    rc1 = procs[1].wait(timeout=300)
    assert rc1 == 17, "worker 1 should have simulated a crash"
    time.sleep(1.0)
    procs[0].send_signal(signal.SIGKILL)
    procs[0].wait(timeout=60)
    assert os.path.isdir(ckpt), "no orbax checkpoint survived the crash"

    # run 2: relaunch; it must RESUME from the sharded snapshot and match
    redo = _finish(_launch(ckpt, total, -1))
    assert all(rc == 0 for rc, _, _ in redo), redo[0][2][-800:]
    steps = [int(l.split()[1]) for l in redo[0][1].splitlines()
             if l.startswith("STEP")]
    assert steps and steps[0] > 1, f"fleet restarted from scratch: {steps[:2]}"
    got = [l.split()[1] for rc, o, _ in redo for l in o.splitlines()
           if l.startswith("CHECKSUM")][0]
    assert got == want, f"resumed trajectory diverged: {got} != {want}"

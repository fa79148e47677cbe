"""Device mesh construction and multi-host initialization (D1).

Axis naming convention used across the package:

  * ``shard`` — the domain-decomposition axis (grid rows/columns split across
    devices; SURVEY.md D5).
  * ``batch`` — optional ensemble/data-parallel axis (D2), outermost.

The mesh follows the algorithm only: the cards of one host are joined all to
all (NVLink), so no device order is closer than another.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host rendezvous (no-op on a single process).

    Wraps jax.distributed.initialize. Pass the coordinator address
    (``host:port``), the process count and this process's id explicitly:
    nothing in a plain GPU host's environment lets JAX infer them.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except RuntimeError:
        # already initialized — idempotent by design (re-init on config
        # change mirrors OceanRenderer.cs:98-109's live re-init)
        pass
    except ValueError:
        # no coordinator and none inferable from the environment: we are a
        # plain single-process run (CI, local dev) — distributed is a no-op
        pass


def make_mesh(shard: Optional[int] = None, batch: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ('batch', 'shard') mesh over the available devices.

    ``shard`` defaults to all devices divided by ``batch``. The shard axis is
    innermost (the halo rings and the FFT all_to_all run over it).
    """
    devices = list(devices if devices is not None else jax.devices())
    if shard is None:
        shard = len(devices) // batch
        if shard < 1:
            raise ValueError(f"batch={batch} exceeds the {len(devices)} "
                             f"available device(s)")
    if batch * shard > len(devices):
        # fail with the real message, not numpy's reshape ValueError
        # (review finding, r5)
        raise ValueError(f"mesh needs batch*shard = {batch * shard} "
                         f"devices; only {len(devices)} available")
    if batch * shard != len(devices):
        devices = devices[: batch * shard]
    arr = np.asarray(devices).reshape(batch, shard)
    return Mesh(arr, axis_names=("batch", "shard"))

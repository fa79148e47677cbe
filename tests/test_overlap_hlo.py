"""Structural proof of the transpose/compute overlap (VERDICT r1 #4).

True transfer/compute overlap is a backend *schedule* property
(all-to-all-start of chunk k issued before the column transforms of chunk
k−1 retire) and can only be observed in a multi-device GPU compile and
trace.
What CAN be proven — and what the overlap structurally requires — is chunk
INDEPENDENCE in the compiled HLO:

  1. chunking survives compilation: the optimized module keeps one
     all-to-all per chunk (nothing merged them back into one barrier);
  2. no all-to-all transitively depends on another all-to-all's result —
     the exact property XLA's latency-hiding scheduler needs to hoist
     chunk k+1's row pass over chunk k's collective. If a refactor
     accidentally serializes the chunks through a data dependency (e.g.
     concatenating chunk results before the next chunk's row FFT), test 2
     fails.

docs/coverage.md D4 records the scope: within-step overlap, structurally
verified; wall-clock overlap needs a pod-slice profile.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from tpu_ocean.parallel import make_mesh
from tpu_ocean.fft.distributed import ifft2_x_sharded

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*[^=]*?"
                    r"\b([a-z][\w\-]*)\((.*)$")
_OPERAND = re.compile(r"%([\w.\-]+)")


def _dep_graph(hlo_text: str):
    """instruction name -> (opcode, operand names) across all computations."""
    graph = {}
    for line in hlo_text.splitlines():
        # tuple types embed /*index=N*/ comments whose '=' defeats the
        # opcode matcher
        line = re.sub(r"/\*.*?\*/", "", line)
        m = _INSTR.match(line)
        if not m:
            continue
        name, opcode, rest = m.groups()
        operands = _OPERAND.findall(rest)
        graph[name] = (opcode, operands)
    return graph


def _ancestors(graph, start):
    seen = set()
    stack = [start]
    while stack:
        cur = stack.pop()
        for op in graph.get(cur, (None, ()))[1]:
            if op not in seen:
                seen.add(op)
                stack.append(op)
    return seen


def _compiled_hlo(chunks: int, n: int = 64):
    mesh = make_mesh(shard=8)
    fn = shard_map(
        lambda a: ifft2_x_sharded(a, "shard", "matmul",
                                  overlap_chunks=chunks),
        mesh=mesh, in_specs=(P(None, "shard", None),),
        out_specs=P(None, None, "shard"))
    x = jnp.zeros((5, n, n), jnp.complex64)
    return jax.jit(fn).lower(x).compile().as_text()


def test_chunked_transform_keeps_one_collective_per_chunk():
    hlo = _compiled_hlo(chunks=5)
    graph = _dep_graph(hlo)
    a2a = [k for k, (op, _) in graph.items() if op.startswith("all-to-all")]
    assert len(a2a) == 5, (
        f"expected 5 all-to-alls (one per chunk), found {len(a2a)} — "
        f"chunking was merged or eliminated")


def test_chunk_collectives_are_mutually_independent():
    hlo = _compiled_hlo(chunks=5)
    graph = _dep_graph(hlo)
    a2a = [k for k, (op, _) in graph.items() if op.startswith("all-to-all")]
    assert len(a2a) >= 2
    for i, tgt in enumerate(a2a):
        anc = _ancestors(graph, tgt)
        for j, other in enumerate(a2a):
            assert i == j or other not in anc, (
                f"all-to-all {tgt} transitively depends on {other}: the "
                f"chunks serialized — overlap is structurally impossible")


def test_unchunked_transform_has_single_collective():
    hlo = _compiled_hlo(chunks=1)
    graph = _dep_graph(hlo)
    a2a = [k for k, (op, _) in graph.items() if op.startswith("all-to-all")]
    assert len(a2a) == 1

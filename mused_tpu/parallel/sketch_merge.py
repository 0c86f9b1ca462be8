"""Multi-chip FD sketch merging over the interconnect.

The mergeability lever (SURVEY.md §2.8): FD(concat(A1, A2)) is approximated
by FD(stack(B1, B2)) with additive error, so per-chip sketches combine with
collectives instead of shipping raw rows.  This module provides both merge
topologies from SURVEY.md §5.8:

  * ``allgather_merge`` — one ``all_gather`` of the (ell, d) blocks followed
    by a single local shrink; peak memory (p+1)*ell x d, one eigh.
  * ``ring_merge``      — p-1 ``ppermute`` hops interleaving stack+shrink;
    peak memory 2*ell x d, p-1 small eighs.  The bandwidth-optimal choice
    when p*ell*d exceeds VMEM budgets.

Plus ``global_max_row_norm`` (psum/pmax replacing the host computation of R
at reference main.py:61) and ``distributed_fd`` — the full row-sharded
sketching step (each chip sketches its row shard, merge = collective).
All functions are written for ``shard_map`` bodies over a mesh "data" axis.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mused_tpu.ops import fd

shard_map = jax.shard_map


def merge_stacked(sketches: jax.Array, out_ell: int):
    """(p, ell, d) stacked sketches -> ((out_ell, d) merged sketch, shrink
    delta) — fd.shrink's 2-tuple, NOT the bare sketch (callers unpack)."""
    p, ell, d = sketches.shape
    return fd.shrink(sketches.reshape(p * ell, d), out_ell)


def allgather_merge(local_sketch: jax.Array, out_ell: int,
                    axis_name: str = "data") -> jax.Array:
    """Inside shard_map: gather every chip's (ell, d) sketch, shrink locally.
    All chips compute the identical merged sketch (replicated output)."""
    gathered = jax.lax.all_gather(local_sketch, axis_name)   # (p, ell, d)
    merged, _ = merge_stacked(gathered, out_ell)
    return merged


def ring_merge(local_sketch: jax.Array, axis_name: str = "data") -> jax.Array:
    """Inside shard_map: ring-rotate sketches p-1 hops, shrinking after each
    receive.  Keeps peak memory at 2*ell x d; every chip ends with an FD
    sketch of the union of all chips' rows."""
    p = jax.lax.axis_size(axis_name)
    ell = local_sketch.shape[0]
    perm = [(i, (i + 1) % p) for i in range(p)]

    def hop(carry, _):
        acc, inflight = carry
        received = jax.lax.ppermute(inflight, axis_name, perm)
        acc, _ = fd.shrink(jnp.concatenate([acc, received], axis=0), ell)
        return (acc, received), None

    (merged, _), _ = jax.lax.scan(hop, (local_sketch, local_sketch), None,
                                  length=p - 1)
    return merged


def global_max_row_norm(rows: jax.Array, axis_name: str = "data") -> jax.Array:
    """R = max over ALL chips' rows of ||row||^2 (reference main.py:61,
    computed with a pmax instead of a host reduction)."""
    local = jnp.max(jnp.sum(rows * rows, axis=1))
    return jax.lax.pmax(local, axis_name)


@functools.partial(jax.jit, static_argnames=("ell", "mesh", "topology"))
def distributed_fd(rows: jax.Array, *, ell: int, mesh, topology: str = "allgather"):
    """Row-sharded FD sketch of (n, d) rows over the mesh "data" axis.

    Each chip runs the scanned block-FD over its n/p row shard (perfectly
    parallel — FD is a mergeable summary), then sketches merge over the interconnect.
    Returns the replicated (ell, d) merged sketch.
    """
    def body(shard):
        st = fd.update_stream(fd.init(ell, shard.shape[1]), shard)
        if topology == "ring":
            merged = ring_merge(st.sketch)
        else:
            merged = allgather_merge(st.sketch, ell)
        return merged[None]   # (1, ell, d) per chip -> (p, ell, d) stacked

    stacked = shard_map(
        body, mesh=mesh,
        in_specs=P("data", None),
        out_specs=P("data", None, None),
        check_vma=False,
    )(rows)
    # allgather: all p copies identical; ring: each chip's own union sketch —
    # either way chip 0's copy is the answer
    return stacked[0]

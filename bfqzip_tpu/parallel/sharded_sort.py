"""Distributed sample sort over a mesh axis.

Building block for the sequence-sharded (multi-chip) EBWT: the global suffix
sort becomes  local sort -> splitter agreement (all_gather of local samples)
-> bucket exchange (all_to_all) -> local merge.  This is the
device replacement for the reference's external-memory pile partitioning
(bfq_ext.cpp:190-348), whose alphabet piles are a 6-way static bucket
exchange on disk.

Values are exchanged in fixed-capacity buckets (static shapes); skewed inputs
that overflow a bucket report the overflow count so the caller can rerun with
a larger factor.  Returns, per shard, a sorted buffer padded with SENTINEL and
the count of real values it holds; the concatenation of shard buffers in axis
order is globally sorted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

SENTINEL = jnp.int32(2**31 - 1)


def sharded_sort(x, mesh: Mesh, axis: str = "seq", capacity_factor: float = 2.0):
    """Globally sort an i32 array sharded over `axis` rows.

    x: [D*m] sharded P(axis).  Returns (buf [D*cap] per shard, count, overflow)
    with buf ascending and padded with SENTINEL past count.
    """
    d = mesh.shape[axis]
    m = x.shape[0] // d
    cap = int(capacity_factor * m / d) + 64

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def inner(xl):
        xl = xl.reshape(-1)  # [m] local
        xs = jnp.sort(xl)
        # splitters: d evenly spaced local samples per device, gathered and
        # re-sampled globally (classic sample sort)
        step = max(m // d, 1)
        samples = xs[jnp.arange(d, dtype=jnp.int32) * step]
        allsamp = jnp.sort(jax.lax.all_gather(samples, axis).reshape(-1))  # [d*d]
        splitters = allsamp[jnp.arange(1, d, dtype=jnp.int32) * d]  # [d-1]

        # bucket of each (sorted) element and bucket boundaries
        bucket = jnp.searchsorted(splitters, xs, side="right").astype(jnp.int32)
        starts = jnp.searchsorted(bucket, jnp.arange(d, dtype=jnp.int32), side="left").astype(jnp.int32)
        ends = jnp.searchsorted(bucket, jnp.arange(d, dtype=jnp.int32), side="right").astype(jnp.int32)
        cnt = ends - starts
        overflow = jnp.sum(jnp.maximum(cnt - cap, 0))

        cols = jnp.arange(cap, dtype=jnp.int32)[None, :]
        src = jnp.minimum(starts[:, None] + cols, m - 1)
        send = jnp.where(cols < jnp.minimum(cnt, cap)[:, None], xs[src], SENTINEL)  # [d, cap]

        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0, tiled=True)  # [d, cap]
        buf = jnp.sort(recv.reshape(-1))  # [d*cap], sentinels sort last
        count = jnp.sum((buf != SENTINEL).astype(jnp.int32))
        return buf[None, :], count[None], overflow[None]

    buf, count, overflow = inner(x)
    return buf.reshape(-1), count, overflow

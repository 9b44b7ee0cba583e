"""Multi-host execution: the sequence-sharded pipeline across processes.

The reference's only scale-out is single-machine threads
(BFQzip_parallel.py:104-119).  Here the same global-EBWT kernel that runs on
one host's devices (parallel/global_pipeline.py) runs unchanged across hosts:
`jax.distributed` brings every host's devices into one global device list,
the mesh axis spans them, and the kernel's collectives (all_to_all bucket
exchanges) need no code changes —
each process only feeds its local read shard and receives its local output
shard.

Launch one process per host with:

    from bfqzip_tpu.parallel import multihost
    multihost.initialize("coord-host:1234", num_processes=H, process_id=h)
    out_local, stats = multihost.smooth_fastq_sharded_multihost(
        local_batch, cfg, multihost.global_mesh())

Tested with 2 CPU processes x 4 virtual devices in
tests/test_multihost.py (spawned subprocesses, byte-equality vs the
single-process engine).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.io.fastq import ReadBatch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize passthrough (env-var autodetection when
    arguments are omitted, e.g. under a cluster launcher)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "seq") -> Mesh:
    """One mesh axis spanning every device of every process."""
    return Mesh(np.array(jax.devices()).reshape(-1), (axis,))


def smooth_fastq_sharded_multihost(
    local_batch: ReadBatch,
    cfg: SmoothConfig | None = None,
    mesh: Mesh | None = None,
    axis: str = "seq",
    capacity_factor: float = 2.5,
) -> Tuple[ReadBatch, dict]:
    """Run the sequence-sharded pipeline with reads fed per process.

    Every process passes its CONTIGUOUS equal-size share of the global read
    collection (process order == device order; pad the collection so the
    global read count divides the mesh axis before slicing).  Returns this
    process's share of the smoothed reads plus the (replicated) stats.
    """
    from bfqzip_tpu.parallel.global_pipeline import _make_pipeline_kernel

    if not jax.config.jax_enable_x64:
        raise RuntimeError("smooth_fastq_sharded_multihost requires jax_enable_x64")
    cfg = cfg or SmoothConfig()
    mesh = mesh if mesh is not None else global_mesh(axis)
    d = mesh.shape[axis]
    n_local, width = local_batch.seqs.shape
    n_global = n_local * jax.process_count()
    if n_global % d:
        raise ValueError(f"global read count {n_global} must divide the mesh axis {d}")

    row = NamedSharding(mesh, P(axis))
    vec = NamedSharding(mesh, P(axis))
    gs = jax.make_array_from_process_local_data(row, np.ascontiguousarray(local_batch.seqs),
                                                (n_global, width))
    gq = jax.make_array_from_process_local_data(row, np.ascontiguousarray(local_batch.quals),
                                                (n_global, width))
    gl = jax.make_array_from_process_local_data(
        vec, np.ascontiguousarray(local_batch.lengths.astype(np.int32)), (n_global,))

    for _ in range(3):
        fn = _make_pipeline_kernel(mesh, axis, n_global, width,
                                   int(capacity_factor * 1000), cfg)
        o_seqs, o_quals, o_lengths, stats, overflow = fn(gs, gq, gl)
        if int(np.asarray(overflow.addressable_data(0))) == 0:
            break
        capacity_factor *= 2

    def local_of(garr):
        shards = sorted(
            garr.addressable_shards,
            key=lambda s: (s.index[0].start or 0) if s.index else 0,
        )
        return np.concatenate([np.asarray(s.data) for s in shards])

    out = ReadBatch(
        seqs=local_of(o_seqs),
        quals=local_of(o_quals),
        lengths=local_of(o_lengths).astype(np.int32),
        headers=local_batch.headers,
    )
    stats_h = {k: int(np.asarray(v.addressable_data(0))) for k, v in stats.items()}
    return out, stats_h

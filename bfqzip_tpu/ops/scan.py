"""Segmented scans: per-cluster state without per-cluster indexed ops.

The reference walks clusters sequentially and keeps per-cluster accumulators
(bfq_int.cpp:636-737).  Here every per-cluster quantity is a segmented scan
over the whole EBWT that restarts at cluster opens, so no array is ever
addressed by cluster id.

This module provides a generic segmented scan with the semantics

    out[i] = x[i]                    if flag[i]
             combine(out[i-1], x[i]) otherwise

(i.e. `flag` RESTARTS the scan at i).  `x` is [n] or channel-first [C, n].
Implementation: positions are viewed as [nb, 128] contiguous blocks; the
in-block inclusive scan is a Hillis-Steele segmented-scan network — 7
combine steps of shifted operands on a [C, nb, 128] view — and the
cross-block prefix over [C, nb] block summaries is computed by RECURSION on
this same function, with `jax.lax.associative_scan` only at the <=4K base
case.  Whether this shape or `lax.associative_scan` over the whole array is
faster on the GPU has not been measured (ROADMAP A4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_B = 128  # in-block width of the Hillis-Steele network
_LOG_B = 7


def _seg_scan(x: jax.Array, flag: jax.Array, combine, init):
    """Generic segmented scan (see module docstring).  x: [n] or [C, n];
    flag: [n] bool; init: identity element of `combine` (scalar)."""
    chanfirst = x.ndim == 2
    n0 = x.shape[-1]
    pad = (-n0) % _B
    if pad:
        padw = ((0, 0), (0, pad)) if chanfirst else ((0, pad),)
        x = jnp.pad(x, padw, constant_values=init)
        flag = jnp.concatenate([flag, jnp.ones((pad,), bool)])
    n = n0 + pad
    nb = n // _B

    shape = (x.shape[0], nb, _B) if chanfirst else (nb, _B)
    v = x.reshape(shape)
    f = flag.reshape(nb, _B)  # broadcasts against the leading channel axis

    # Hillis-Steele segmented-scan network along the lane axis:
    #   (v1,f1) o (v2,f2) = (f2 ? v2 : combine(v1,v2), f1|f2)
    pad_cfg = [(0, 0)] * (v.ndim - 1)
    for s in range(_LOG_B):
        d = 1 << s
        vs = jnp.pad(v[..., :-d], pad_cfg + [(d, 0)], constant_values=init)
        fs = jnp.pad(f[:, :-d], ((0, 0), (d, 0)), constant_values=False)
        v = jnp.where(f, v, combine(vs, v))
        f = f | fs

    # cross-block: inclusive restart-scan over (tail value, had flag)
    tail = v[..., -1]  # [(C,) nb]
    hr = f[:, -1]  # [nb]
    if nb > 4096:
        pt = _seg_scan(tail, hr, combine, init)
    else:
        hrx = hr[None, :] if chanfirst else hr

        def op(a, b):
            av, af = a
            bv, bf = b
            return (jnp.where(bf, bv, combine(av, bv)), af | bf)

        pt, _ = jax.lax.associative_scan(op, (tail, hrx), axis=-1)

    zero = jnp.full_like(pt[..., :1], init)
    pexcl = jnp.concatenate([zero, pt[..., :-1]], axis=-1)  # [(C,) nb]
    out = jnp.where(f, v, combine(pexcl[..., None], v))
    out = out.reshape(x.shape)
    return out[..., :n0]


def seg_cumsum(x: jax.Array, reset: jax.Array) -> jax.Array:
    """Inclusive segmented cumsum; `reset[i]` starts a new segment AT i.
    x: [n] or channel-first [C, n]."""
    return _seg_scan(x, reset, jnp.add, 0)


def seg_cummax(x: jax.Array, reset: jax.Array) -> jax.Array:
    info = jnp.iinfo(x.dtype) if jnp.issubdtype(x.dtype, jnp.integer) else None
    lo = info.min if info else -jnp.inf
    return _seg_scan(x, reset, jnp.maximum, lo)


def seg_cumor(x: jax.Array, reset: jax.Array) -> jax.Array:
    return _seg_scan(x, reset, jnp.bitwise_or, 0)


def last_marked(x: jax.Array, mark: jax.Array, init=0) -> jax.Array:
    """out[i] = x at the most recent mark <= i.

    Before the first mark the result is `init` only where x == init at every
    unmarked position (callers pass jnp.where(mark, x, init)): keep-left has
    no identity, so the network carries x[0] across blocks otherwise."""
    return _seg_scan(x, mark, lambda a, b: a, init)


def next_marked(x: jax.Array, mark: jax.Array, init=0) -> jax.Array:
    """out[i] = x at the nearest mark >= i (init after the last mark, given
    x == init at unmarked positions; see last_marked)."""
    return last_marked(x[::-1], mark[::-1], init)[::-1]


# ---------------------------------------------------------------------------
# Free-scan variants for single channels: for NON-NEGATIVE integer payloads
# whose plain cumsum stays within the dtype, segmented scans reduce to XLA's
# native cumsum/cummax:
#
#   seg_cumsum(x, reset) = S - cummax(reset ? S - x : INT_MIN),  S = cumsum(x)
#
# because S is non-decreasing (x >= 0), so the packed reset-anchors are
# monotone and plain cummax selects the most recent one.  Positions before
# the first reset yield wrapped garbage - callers mask to segment members.
# ---------------------------------------------------------------------------


class LocalScanOps:
    """Single-device scan/shift toolbox used by ops.smooth.

    The same interface is implemented over a mesh axis by
    parallel.dist_scan.DistScanOps (local op + one collective carry step), so
    the smoothing maths in ops/smooth.py is written once and runs either
    single-chip or sequence-sharded.
    """

    def iota(self, n: int) -> jax.Array:
        """Global position of each local slot."""
        return jnp.arange(n, dtype=jnp.int32)

    def shift_prev(self, x: jax.Array, fill) -> jax.Array:
        """out[i] = x[i-1] (global); out[0] = fill."""
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    def shift_next(self, x: jax.Array, fill) -> jax.Array:
        """out[i] = x[i+1] (global); out[-1] = fill."""
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    def shift_next_k(self, x: jax.Array, k: int, fill) -> jax.Array:
        """out[i] = x[i+k] (global); the last k slots get fill."""
        return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])

    def cummax(self, x: jax.Array) -> jax.Array:
        return jax.lax.cummax(x)

    def seg_scan(self, x: jax.Array, flag: jax.Array, combine, init) -> jax.Array:
        return _seg_scan(x, flag, combine, init)

    def seg_cumsum(self, x: jax.Array, reset: jax.Array) -> jax.Array:
        return self.seg_scan(x, reset, jnp.add, 0)

    def seg_cummax(self, x: jax.Array, reset: jax.Array) -> jax.Array:
        """Segmented max for non-negative x (identity 0)."""
        return self.seg_scan(x, reset, jnp.maximum, 0)

    def seg_cumor(self, x: jax.Array, reset: jax.Array) -> jax.Array:
        return self.seg_scan(x, reset, jnp.bitwise_or, 0)

    def next_marked(self, x: jax.Array, mark: jax.Array, init=0) -> jax.Array:
        return next_marked(x, mark, init)

    def sum(self, x: jax.Array) -> jax.Array:
        """Global sum reduction (psum over the mesh axis when sharded)."""
        return jnp.sum(x)


LOCAL_OPS = LocalScanOps()


def seg_cumsum_nn(x: jax.Array, reset: jax.Array) -> jax.Array:
    """Inclusive segmented cumsum for x >= 0 (and cumsum(x) within dtype)."""
    s = jnp.cumsum(x, dtype=x.dtype)
    lo = jnp.iinfo(x.dtype).min
    anchor = jax.lax.cummax(jnp.where(reset, s - x, lo))
    return s - anchor


def last_marked_nn(val: jax.Array, mark: jax.Array) -> jax.Array:
    """out[i] = val at the most recent mark <= i, for val >= 0 (garbage
    before the first mark; callers mask)."""
    return seg_cumsum_nn(jnp.where(mark, val, jnp.zeros((), val.dtype)), mark)


def next_marked_nn(val: jax.Array, mark: jax.Array) -> jax.Array:
    """out[i] = val at the nearest mark >= i, for val >= 0 (garbage after
    the last mark; callers mask)."""
    return last_marked_nn(val[::-1], mark[::-1])[::-1]

"""LocalScanOps (the smoothing stage's scan toolbox) against plain loops.

Sizes include one that is not a multiple of the 128-wide block and one with
more than 4096 blocks, which takes the recursive cross-block carry of
ops/scan._seg_scan.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from bfqzip_tpu.ops.scan import LOCAL_OPS

SIZES = (1_000, 600_001)  # 600_001 positions = 4688 blocks of 128


@functools.lru_cache(maxsize=None)
def _data(n, channels):
    rng = np.random.default_rng(n + channels)
    shape = (channels, n) if channels else (n,)
    x = rng.integers(0, 64, shape).astype(np.int32)
    flag = rng.random(n) < 0.01
    flag[rng.integers(0, n)] = False
    return x, flag


def _loop_seg(x, flag, combine):
    """out[i] = x[i] at a flag, else combine(out[i-1], x[i]); 0 before any."""
    x2 = x.reshape(-1, x.shape[-1])
    out = np.empty_like(x2)
    for c in range(x2.shape[0]):
        acc = 0
        row = x2[c].tolist()
        res = out[c]
        for i, (v, f) in enumerate(zip(row, flag.tolist())):
            acc = v if f else combine(acc, v)
            res[i] = acc
    return out.reshape(x.shape)


def _loop_next_marked(x, mark):
    """out[i] = x at the nearest mark >= i; 0 after the last mark."""
    out = np.zeros_like(x)
    nxt = 0
    xs, ms = x.tolist(), mark.tolist()
    for i in range(len(xs) - 1, -1, -1):
        if ms[i]:
            nxt = xs[i]
        out[i] = nxt
    return out


REFS = {
    "seg_cumsum": lambda x, f: _loop_seg(x, f, lambda a, b: a + b),
    "seg_cummax": lambda x, f: _loop_seg(x, f, max),
    "seg_cumor": lambda x, f: _loop_seg(x, f, lambda a, b: a | b),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("op", sorted(REFS))
def test_segmented_ops_match_loop(op, channels, n):
    x, flag = _data(n, channels)
    got = np.asarray(getattr(LOCAL_OPS, op)(jnp.asarray(x), jnp.asarray(flag)))
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_array_equal(got, REFS[op](x, flag))


@pytest.mark.parametrize("n", SIZES)
def test_next_marked_matches_loop(n):
    x, flag = _data(n, 0)
    x = np.where(flag, x, 0)  # the callers' contract: init off the marks
    want = _loop_next_marked(x, flag)
    got = np.asarray(LOCAL_OPS.next_marked(jnp.asarray(x), jnp.asarray(flag)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_cummax_matches_numpy(n):
    x, _ = _data(n, 0)
    x = x - 32  # negative values too: the plain cummax has no identity floor
    got = np.asarray(LOCAL_OPS.cummax(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))

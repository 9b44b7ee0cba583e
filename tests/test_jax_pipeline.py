"""Validate the JAX compute path against the numpy model and the reference
binary's golden outputs (byte equality of the reconstructed FASTQ)."""

import numpy as np
import pytest

from bfqzip_tpu import alphabet, ref_golden
from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.engine import smooth_fastq
from bfqzip_tpu.io.fastq import format_fastq, read_fastq
from bfqzip_tpu.ops.suffix import build_ebwt

from conftest import golden_path
from tests_util import tiny_batch


def _load(name):
    return read_fastq(golden_path(f"{name}.in.fastq"))


@pytest.mark.parametrize("dataset", ["example", "synth_var", "synth_long"])
def test_ebwt_matches_numpy(dataset):
    batch = _load(dataset)
    ref = ref_golden.build_ebwt(batch)
    dev = build_ebwt(np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))
    n = int(dev.n)
    assert n == ref.bwt.size
    assert np.array_equal(np.asarray(dev.bwt)[:n], ref.bwt)
    assert np.array_equal(np.asarray(dev.qs)[:n], ref.qs)
    assert np.array_equal(np.asarray(dev.lcp)[:n], ref.lcp)


def test_ebwt_random_tiny():
    rng = np.random.default_rng(3)
    for _ in range(5):
        batch = tiny_batch(rng, n_reads=25, min_len=2, max_len=14)
        ref = ref_golden.build_ebwt(batch)
        dev = build_ebwt(np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))
        n = int(dev.n)
        assert np.array_equal(np.asarray(dev.bwt)[:n], ref.bwt)
        assert np.array_equal(np.asarray(dev.lcp)[:n], ref.lcp)


def test_bucket_padding_inert():
    """Dummy length -1 rows (shape bucketing) must not change the EBWT or the
    smoothed output beyond appending zero-length rows."""
    from bfqzip_tpu.io.fastq import bucket_shape, pad_batch

    rng = np.random.default_rng(5)
    batch = tiny_batch(rng, n_reads=37, min_len=5, max_len=21, n_frac=0.02)
    padded = pad_batch(batch)
    assert padded.num_reads >= batch.num_reads and padded.max_len >= batch.max_len
    a = build_ebwt(np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))
    b = build_ebwt(np.asarray(padded.seqs), np.asarray(padded.quals), np.asarray(padded.lengths))
    n = int(a.n)
    assert n == int(b.n)
    for f in ("bwt", "qs", "lcp"):
        assert np.array_equal(np.asarray(getattr(a, f))[:n], np.asarray(getattr(b, f))[:n]), f
    # bucketing is idempotent and monotone
    for nr, w in ((1, 3), (100, 101), (129, 101), (200_000, 101), (12_345, 250)):
        n1, w1 = bucket_shape(nr, w)
        assert n1 >= nr and w1 >= w
        assert bucket_shape(n1, w1) == (n1, w1) or n1 <= 128


def test_pad_to_shape_smooths_the_same():
    """pad_batch to an explicit larger shape (how several datasets share one
    compilation) leaves the smoothed reads unchanged."""
    from bfqzip_tpu.io.fastq import pad_batch

    rng = np.random.default_rng(11)
    batch = tiny_batch(rng, n_reads=37, min_len=5, max_len=21, n_frac=0.02)
    padded = pad_batch(batch, (50, 30))
    assert padded.seqs.shape == (50, 30)
    assert np.all(padded.lengths[37:] == -1)
    a, _ = smooth_fastq(batch, SmoothConfig(mode=3, k=4, min_cluster=3))
    b, _ = smooth_fastq(padded, SmoothConfig(mode=3, k=4, min_cluster=3))
    assert format_fastq(a, headers=None) == format_fastq(
        type(a)(seqs=b.seqs[:37], quals=b.quals[:37], lengths=b.lengths[:37]), headers=None
    )


def test_ebwt_flat_doubling_agree():
    """Both sort strategies must produce identical artifacts; the flat path
    additionally carries the smoother's predecessor symbols (bwt[LF])."""
    from bfqzip_tpu.ops.suffix import _build_ebwt_doubling, _build_ebwt_flat

    rng = np.random.default_rng(7)
    for n_reads, min_len, max_len in ((40, 2, 35), (12, 30, 33), (30, 9, 10)):
        batch = tiny_batch(rng, n_reads=n_reads, min_len=min_len, max_len=max_len, n_frac=0.02)
        args = (np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))
        flat = _build_ebwt_flat(*args)
        dbl = _build_ebwt_doubling(*args)
        n = int(flat.n)
        assert n == int(dbl.n)
        assert np.array_equal(np.asarray(flat.sa)[:n], np.asarray(dbl.sa)[:n])
        assert np.array_equal(np.asarray(flat.bwt)[:n], np.asarray(dbl.bwt)[:n])
        assert np.array_equal(np.asarray(flat.qs)[:n], np.asarray(dbl.qs)[:n])
        assert np.array_equal(np.asarray(flat.lcp)[:n], np.asarray(dbl.lcp)[:n])
        # pre == symbol at SA-2 (TERM for terminator/padding predecessors)
        n_pad = flat.bwt.shape[0]
        t2 = np.asarray(flat.text)[(np.asarray(flat.sa).astype(np.int64) - 2) % n_pad]
        want = np.where(t2 == 0, 0, t2 - 1).astype(np.uint8)
        assert np.array_equal(np.asarray(flat.pre)[:n], want[:n])


@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var", "synth_long"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_golden_byte_equality(dataset, mode):
    batch = _load(dataset)
    out, _ = smooth_fastq(batch, SmoothConfig(mode=mode))
    golden = open(golden_path(f"{dataset}.m{mode}b0.fq"), "rb").read()
    assert format_fastq(out, headers=None) == golden


@pytest.mark.parametrize("dataset", ["example", "synth_var", "synth_long"])
def test_golden_binning(dataset):
    batch = _load(dataset)
    out, _ = smooth_fastq(batch, SmoothConfig(mode=2, binning=True))
    golden = open(golden_path(f"{dataset}.m2b1.fq"), "rb").read()
    assert format_fastq(out, headers=None) == golden


def test_stats_match_numpy_model():
    batch = _load("example")
    cfg = SmoothConfig(mode=2)
    _, stats = smooth_fastq(batch, cfg)
    _, ref_stats = ref_golden.smooth_fastq(batch, cfg)
    for k in (
        "num_clust",
        "num_clust_discarded",
        "num_clust_amb_discarded",
        "num_clust_mod",
        "num_clust_alleq",
        "bases_inside",
        "modified",
        "qs_smoothed",
    ):
        assert stats[k] == getattr(ref_stats, k), k


def test_mode1_warns_without_x64():
    # library callers bypassing the CLI's JAX_ENABLE_X64=1 must get a loud
    # warning that mean-error smoothing can differ +-1 from the reference
    import warnings

    import jax

    batch = _load("example")
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.warns(RuntimeWarning, match="mean-error"):
            smooth_fastq(batch, SmoothConfig(mode=1))
    finally:
        jax.config.update("jax_enable_x64", True)
    # and no warning under x64 (the supported configuration)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        smooth_fastq(batch, SmoothConfig(mode=1))


def test_smooth_random_vs_numpy():
    rng = np.random.default_rng(11)
    for seed in range(3):
        batch = tiny_batch(rng, n_reads=60, min_len=8, max_len=24, n_frac=0.03)
        cfg = SmoothConfig(mode=2, k=4, min_cluster=3)
        out_jax, st_jax = smooth_fastq(batch, cfg)
        out_np, st_np = ref_golden.smooth_fastq(batch, cfg)
        assert np.array_equal(out_jax.lengths, out_np.lengths)
        w = out_np.max_len
        assert np.array_equal(out_jax.seqs[:, :w], out_np.seqs)
        assert np.array_equal(out_jax.quals[:, :w], out_np.quals)
        assert st_jax["modified"] == st_np.modified
        assert st_jax["qs_smoothed"] == st_np.qs_smoothed

"""Validate the trusted numpy model against outputs of the reference binary.

The golden .fq files were produced by the reference's own compiled bfq_int
(tests/make_golden.py); byte equality here means the numpy model reproduces the
reference exactly, which in turn anchors the JAX path.
"""

import numpy as np
import pytest

from bfqzip_tpu import alphabet, ref_golden
from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.io.fastq import format_fastq, read_fastq

from conftest import golden_path


def _load(name):
    return read_fastq(golden_path(f"{name}.in.fastq"))


@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var", "synth_long"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_modes_headerless(dataset, mode):
    batch = _load(dataset)
    out, _ = ref_golden.smooth_fastq(batch, SmoothConfig(mode=mode))
    golden = open(golden_path(f"{dataset}.m{mode}b0.fq"), "rb").read()
    assert format_fastq(out, headers=None) == golden


@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var", "synth_long"])
def test_binning(dataset):
    batch = _load(dataset)
    out, _ = ref_golden.smooth_fastq(batch, SmoothConfig(mode=2, binning=True))
    golden = open(golden_path(f"{dataset}.m2b1.fq"), "rb").read()
    assert format_fastq(out, headers=None) == golden


@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var", "synth_long"])
def test_with_headers(dataset):
    batch = _load(dataset)
    out, _ = ref_golden.smooth_fastq(batch, SmoothConfig(mode=2))
    golden = open(golden_path(f"{dataset}.m2b0h.fq"), "rb").read()
    assert format_fastq(out) == golden


def test_ebwt_invariants():
    batch = _load("synth_var")
    ebwt = ref_golden.build_ebwt(batch)
    n = ebwt.bwt.size
    assert n == batch.total_bases + batch.num_reads
    # number of terminators == number of reads
    assert int((ebwt.bwt == alphabet.TERM).sum()) == batch.num_reads
    # LF is a permutation
    lf = ref_golden.lf_array(ebwt.bwt)
    assert np.array_equal(np.sort(lf), np.arange(n))
    # inverting without smoothing reproduces the input reads exactly
    out = ref_golden.invert(ebwt, ebwt.bwt, ebwt.qs)
    assert np.array_equal(out.lengths, batch.lengths)
    assert np.array_equal(out.seqs, batch.seqs[:, : out.max_len])
    assert np.array_equal(out.quals, batch.quals[:, : out.max_len])


def test_lcp_against_bruteforce():
    rng = np.random.default_rng(0)
    from tests_util import tiny_batch

    batch = tiny_batch(rng, n_reads=30, min_len=3, max_len=12)
    ebwt = ref_golden.build_ebwt(batch)

    # brute force: materialise all suffixes as python tuples
    sufs = []
    for i in range(batch.num_reads):
        L = int(batch.lengths[i])
        s = [int(c) + batch.num_reads for c in batch.seqs[i, :L]] + [i]
        for k in range(L + 1):
            sufs.append(tuple(s[k:]))
    sufs.sort()
    lcp_bf = [0]
    for a, b in zip(sufs, sufs[1:]):
        h = 0
        while h < min(len(a), len(b)) and a[h] == b[h]:
            h += 1
        lcp_bf.append(h)
    assert ebwt.lcp.tolist() == lcp_bf

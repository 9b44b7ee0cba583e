"""bfqzip_tpu — lossy FASTQ compression on an accelerator via the Extended Burrows-Wheeler Transform.

A ground-up JAX/XLA re-design of the capabilities of veronicaguerrini/BFQzip
(reference layout: BFQzip.py, src_int_mem/bfq_int.cpp, src_ext_mem/bfq_ext.cpp):

  1. EBWT + quality-permutation + LCP construction as a prefix-doubling sort pipeline
     (replaces the gsufsort / eGap external tools, reference BFQzip.py:184).
  2. Positional-cluster detection as a vectorized predicate over the explicit LCP
     array (replaces the suffix-tree DFS of bfq_int.cpp:183-300 and the streaming
     scan of bfq_ext.cpp:350-412).
  3. Noise reduction + quality smoothing as masked segmented reductions
     (replaces bfq_int.cpp:414-626).
  4. FASTQ reconstruction as a batched lock-step LF walk over all reads
     (replaces bfq_int.cpp:748-819 and the BCR decoder src_ext_mem/decode.cpp).
  5. Entropy coding with an interleaved rANS coder (replaces PPMd / libbsc,
     reference BFQzip.py:253-275).

The package is organised as:
  bfqzip_tpu.io        — FASTQ parsing/serialisation (numpy + native C++ backend)
  bfqzip_tpu.ops       — the device compute path (suffix sort, LCP, cluster, smooth,
                         invert, rank/LF, entropy coding)
  bfqzip_tpu.models    — smoothing-strategy models (M=0..3) + entropy context models
  bfqzip_tpu.parallel  — device meshes, data-parallel block pipeline, sharded sort
  bfqzip_tpu.utils     — validation, reordering, profiling, native bindings
  bfqzip_tpu.pipeline  — end-to-end orchestration with artifact caching
  bfqzip_tpu.cli       — command-line drivers mirroring BFQzip.py's surface
"""

__version__ = "0.1.0"

from bfqzip_tpu.config import SmoothConfig, PipelineConfig  # noqa: F401

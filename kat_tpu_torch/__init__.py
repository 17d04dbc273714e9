"""kat_tpu_torch — the K-mer Analysis Toolkit on PyTorch and CUDA.

A port of `kat_tpu` (the JAX/Pallas package beside it) to PyTorch, with the
counting and lookup hot paths in CUDA kernels written for NVIDIA Hopper
(sm_90a).  The
layout mirrors `kat_tpu`, module for module:

    kat_tpu_torch.core   -- 2-bit k-mer packing, window extraction, counting
                            (narrow and wide keys), bulk lookups, window
                            profiles, binned sums and comp's passes
    kat_tpu_torch.ops    -- sort / merge / reduce-by-key / compaction /
                            binned-sums kernels (one int64 key or W words)
                            + plain versions, and the sort-merge join
    kat_tpu_torch.io     -- FASTA/FASTQ readers (Python + native C++), mme
                            headers, the .jf codec
    kat_tpu_torch.tools  -- the `kat hist`, `gcp`, `comp`, `sect`, `cold`
                            and `filter` workloads and input handling
    kat_tpu_torch.parallel -- counting and analysis on a mesh of shards
    kat_tpu_torch.analysis -- peak fitting and distribution analysis
                            (host numpy/scipy)
    kat_tpu_torch.plot   -- the six plot modes (host matplotlib)
    kat_tpu_torch.cli    -- `kat`-compatible command line (every mode)
    kat_tpu_torch.jf_cli -- the jellyfish-compatible `.jf` utilities

Keys are int64 (k <= 31 fits in 62 bits) with INT64_MAX as the sentinel;
wide keys (31 < k <= 255) are ceil(k / 31) int64 words of 31 bases.
Nothing here imports JAX or `kat_tpu`.
"""

__version__ = "0.1.0"

DEFAULT_MER_LEN = 27  # reference: lib/include/kat/jellyfish_helper.hpp:75
DEFAULT_HASH_SIZE = 100_000_000  # reference: jellyfish_helper.hpp:76
DEFAULT_NB_BINS = 1001  # reference: lib/include/kat/comp_counters.hpp:32

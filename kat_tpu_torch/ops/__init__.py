"""Hand-written Hopper kernels for the counting flush, each beside its plain
PyTorch version: sort_kernel (LSD radix sort), merge_kernel (merge-path
merge), reduce_kernel (reduce-by-key + compaction).  The CUDA sources live
in kat_tpu_torch/csrc and are built by ops/_cuda.py at first use."""

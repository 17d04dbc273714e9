"""Hand-written Hopper kernels, each beside its plain PyTorch version:
sort_kernel (LSD radix sort, keys alone or with a value), merge_kernel
(merge-path merge, with payload planes for the join), reduce_kernel
(reduce-by-key, and stable compaction of flagged elements); join is the
sort-merge-join lookup built on them.  The CUDA sources live in
kat_tpu_torch/csrc and are built by ops/_cuda.py at first use."""

"""Hand-written Hopper kernels, each beside its plain PyTorch version:
sort_kernel (LSD radix sort, keys alone, with a value, or of W-word wide
keys), merge_kernel (merge-path merge, with payload planes for the join,
or of W-word keys), reduce_kernel (reduce-by-key of one-word or W-word
keys, and stable compaction of flagged elements), merge_reduce_kernel (K2
and K3 fused, the counting flush's merge and reduce in one pass),
binned_kernel (binned
sums of 0/1 masks, the binned form of kat_tpu's sort + reduce); join is the
sort-merge-join lookup built on them.  The CUDA sources live in
kat_tpu_torch/csrc and are built by ops/_cuda.py at first use."""

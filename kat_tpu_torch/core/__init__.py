"""Compute core: k-mer packing/extraction (kmers), sorted count tables and
the streaming counter (counting), histogram binning (stats)."""

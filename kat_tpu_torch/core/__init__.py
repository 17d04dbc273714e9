"""Compute core: k-mer packing/extraction (kmers), sorted count tables and
the streaming counters (counting; wide for 31 < k <= 255), bulk lookups
over tables (tables), window profiles (coverage), binned sums: histogram,
GC x coverage matrix, spectra (stats), comp's passes (comp_engine), the
spectral distances (distance), the text matrix (matrix)."""

"""Compute core: k-mer packing/extraction (kmers), sorted count tables and
the streaming counters (counting; wide for 31 < k <= 255), bulk lookups
over tables (tables), window profiles (coverage), histogram binning
(stats), the text matrix (matrix)."""

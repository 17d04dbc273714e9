"""Mesh parallelism in one process: k-mer-space sharded counting, the
analysis over sharded tables, and halo-exchanged sequence parallelism."""

"""Host I/O: FASTA/FASTQ readers (Python + native C++), mme text headers,
the jellyfish .jf codec, prefetch pipeline."""

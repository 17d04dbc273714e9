"""Host I/O: FASTA/FASTQ readers (Python + native C++), mme text headers,
prefetch pipeline."""

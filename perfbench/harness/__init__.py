"""The benchmark's machinery: cells, seeded inputs and weights, the
training loop, the trace reader, the FLOP and byte counts, the comparison."""

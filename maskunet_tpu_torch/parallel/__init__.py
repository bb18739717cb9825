"""Data parallelism and the 2-stage GPipe pipeline of the port."""

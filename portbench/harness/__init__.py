"""The general code of the benchmark: what no single cell owns."""

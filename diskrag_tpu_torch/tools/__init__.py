"""Tools of the port: the fused-scan microbenchmark, index and installation
verification, the engine concurrency harness, the dataset, streaming and
serving benchmarks."""

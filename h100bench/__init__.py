"""The H100 benchmark of the PyTorch and CUDA port: cells, configurations,
traffic, limits and metric readers found by the names in BENCHMARK.json."""

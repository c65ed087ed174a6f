"""CPU tests of the benchmark, and its chip tests (marked ``cuda``)."""

"""What the benchmark measures with, kept apart from the program: traffic
generation, the roofline cost functions and peaks, the trace reader, the
FLOP count and the synchronized span wrap."""

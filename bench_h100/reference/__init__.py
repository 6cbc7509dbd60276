"""The plain fp32 reference the benchmark holds the program to."""

"""The benchmark harness of `bench_h100`: drivers, traffic, weights,
profile reduction and the yardstick's counts."""

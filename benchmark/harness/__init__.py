"""The benchmark's yardstick: traffic, weights, counts of operations and
bytes, the trace reduction, the plain reference and the drivers."""

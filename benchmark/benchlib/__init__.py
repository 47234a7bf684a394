"""The benchmark's own library: cells, traffic, weights, drivers, trace reduction."""

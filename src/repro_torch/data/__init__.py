"""Synthetic data sets of the port (numpy, deterministic in the seed)."""

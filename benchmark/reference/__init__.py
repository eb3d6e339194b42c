"""Frozen plain references of the benchmarked detectors: plain PyTorch and
NumPy that import nothing of the program under test."""

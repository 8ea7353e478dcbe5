"""Nearest-neighbor indexes: brute force, IVF-Flat, IVF-BQ and CAGRA."""

"""Synthetic STD data and seeded request streams (NumPy only)."""

"""Synthetic STD data and seeded request streams (NumPy), and the LM
training stream with its host-to-device prefetcher."""
from .pipeline import Prefetcher, TokenDataset

__all__ = ["Prefetcher", "TokenDataset"]

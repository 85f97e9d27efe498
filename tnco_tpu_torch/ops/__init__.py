"""Bitset and log2-cost primitives on torch tensors."""

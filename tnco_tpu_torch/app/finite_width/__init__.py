"""Finite-width (sliced) application driver."""

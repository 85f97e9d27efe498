"""Infinite-memory application drivers."""

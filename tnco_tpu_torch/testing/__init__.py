"""Benchmark networks for the port's smoke run and tests."""

"""Benchmark instances."""

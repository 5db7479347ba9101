"""Seeded input generation for the benchmark."""

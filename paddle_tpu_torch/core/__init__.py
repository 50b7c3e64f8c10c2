"""Dtype names, seeding and device resolution."""

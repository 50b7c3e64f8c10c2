"""Layers."""

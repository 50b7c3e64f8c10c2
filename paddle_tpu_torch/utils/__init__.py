"""Flags."""

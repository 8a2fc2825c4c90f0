"""Synthetic training data (numpy only)."""

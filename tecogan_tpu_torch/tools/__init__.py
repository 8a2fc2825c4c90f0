"""Measurement scripts for the port (GPU only)."""

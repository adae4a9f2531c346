"""Utilities of the port: flax -> torch parameter conversion."""

"""Utilities of the port (parameter conversion from the reference)."""

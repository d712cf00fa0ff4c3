"""Launching the port: the rank world of mesh rows."""

"""Core operators of the port (the KV subset of `repro.core.operators`)."""

"""Runnable user paths of the port: ``python -m repro_torch.examples.<name>``."""

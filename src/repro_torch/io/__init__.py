"""Decoupled I/O of the port: the io service group and its host sink."""

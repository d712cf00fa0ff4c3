"""Data pipeline (a numpy copy of the reference's, same tokens from the same seed)."""

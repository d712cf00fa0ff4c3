"""The paper's applications on the port's dataflow runtime."""

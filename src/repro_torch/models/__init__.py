"""Model code of the port: `layers`, `transformer`, and `model_zoo.build`.

Nothing is imported here, so the kernels' plain versions can import
`layers` without pulling in the model zoo (which imports the kernels)."""

"""See the package docstring of hoigen_tpu_torch."""

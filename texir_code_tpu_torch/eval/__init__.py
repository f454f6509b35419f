"""Part of the texir_code_tpu_torch port (see the package docstring)."""

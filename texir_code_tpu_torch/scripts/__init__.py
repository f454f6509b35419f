"""Measurement harnesses of the port, run as modules
(`python -m texir_code_tpu_torch.scripts.<name>`)."""

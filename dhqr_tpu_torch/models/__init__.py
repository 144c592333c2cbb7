"""models of the PyTorch port (see dhqr_tpu_torch/__init__.py)."""

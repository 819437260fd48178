"""Entry points of the port: ``python -m flashgmm_tpu_torch.examples.train``."""

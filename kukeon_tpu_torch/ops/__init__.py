"""Ops of the port: torch counterparts of ``kukeon_tpu/ops``."""

"""Models of the port: torch counterparts of ``kukeon_tpu/models``."""

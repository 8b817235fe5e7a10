"""Runtime of the port: the serving cell (``kukeon_tpu/runtime/serving_cell.py``)."""

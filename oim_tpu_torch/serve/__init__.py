"""Serving (``oim_tpu/serve``): so far only the packed-weights blob."""

"""Utilities of the port that meet a runtime's APIs (counterpart of
``ray_tpu/util``)."""

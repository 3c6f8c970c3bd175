"""Measurement entry points of the port (counterpart of `rlap_tpu/bench`)."""

"""Utilities of the port (counterpart of `rlap_tpu/utils`)."""

"""Utilities: image IO (a copy of ash_tpu/utils)."""

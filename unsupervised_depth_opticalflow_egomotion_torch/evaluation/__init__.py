"""Evaluation helpers (the port's copies; the metrics come with the eval slice)."""

from .flow_io import flow_to_image

__all__ = ["flow_to_image"]

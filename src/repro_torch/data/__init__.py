"""Synthetic training data: the copy of the reference's token pipeline."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]

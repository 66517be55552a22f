from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]

from .pipeline import DataConfig, SyntheticDataset

__all__ = ["DataConfig", "SyntheticDataset"]

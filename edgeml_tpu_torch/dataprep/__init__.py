from .split import split_dataset

__all__ = ["split_dataset"]

"""Datasets and the batching loader (numpy; the trainer moves batches to its
device)."""

from .datasets import (
    CachedDataset,
    ImageFolderDataset,
    ImageNet64Dataset,
    NaturalSynthetic,
    RandomScaledImages,
    SyntheticImages,
)
from .loader import CommonDataLoader, CustomDataLoader, DataLoader

__all__ = [
    "CachedDataset",
    "ImageFolderDataset",
    "ImageNet64Dataset",
    "NaturalSynthetic",
    "RandomScaledImages",
    "SyntheticImages",
    "DataLoader",
    "CommonDataLoader",
    "CustomDataLoader",
]

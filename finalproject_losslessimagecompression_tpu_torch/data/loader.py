"""Batching data loader with replication padding + grid rounding.

The port's own copy of the JAX package's `data/loader.py`: batches of NHWC
float32 images in [0, 1] (numpy), right/bottom replication-padded to the
model's dims and rounded to the 2^-nbits grid, which is what makes inputs
codable.  Training loaders cycle forever with a seeded shuffle per epoch;
eval loaders iterate once in order.  The trainer moves each batch to its
device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..registry import DATALOADERS, DATASETS, build
from .datasets import CachedDataset


def _pad_replicate(batch: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    if not pad_h and not pad_w:
        return batch
    return np.pad(
        batch, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)), mode="edge"
    )


def _round_grid(batch: np.ndarray, nbits: int) -> np.ndarray:
    bins = 2.0 ** nbits
    return np.round(batch * bins) / np.float32(bins)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        nbits: int = 8,
        train: bool = False,
        pad: Optional[Sequence[int]] = None,
        seed: int = 0,
        drop_last: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """shard_index/shard_count: data sharding across processes -- every
        process draws the SAME seeded permutation and takes a disjoint
        stride of it, so global batches partition deterministically."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.nbits = nbits
        self.train = train
        self.pad = tuple(pad) if pad else (0, 0)
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._epoch = 0
        self._iter = self._make_iter()

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch])
            )
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.shard_count > 1:
            order = order[self.shard_index :: self.shard_count]
        return order

    def _make_iter(self) -> Iterator[np.ndarray]:
        order = self._order()
        bs = self.batch_size
        for i in range(0, len(order), bs):
            idxs = order[i : i + bs]
            if self.drop_last and len(idxs) < bs:
                return
            batch = np.stack([self.dataset[int(j)] for j in idxs])
            batch = _pad_replicate(batch, self.pad[0], self.pad[1])
            yield _round_grid(batch, self.nbits).astype(np.float32)

    def __iter__(self):
        self._iter = self._make_iter()
        return self

    def __next__(self) -> np.ndarray:
        try:
            return next(self._iter)
        except StopIteration:
            self._epoch += 1
            self._iter = self._make_iter()
            if self.train:
                return next(self._iter)  # cycle forever
            raise


def _resolve_shard(shard, shard_index, shard_count):
    """`shard: true` takes the process coordinates from torch.distributed
    when it is initialised, and is (0, 1) otherwise; explicit
    shard_index/shard_count override."""
    if shard_index is not None or shard_count is not None:
        return int(shard_index or 0), int(shard_count or 1)
    if shard:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _loader(ds, batch_size, shuffle, nbits, train, pad, seed, cache, shard,
            shard_index, shard_count) -> DataLoader:
    if cache:
        ds = CachedDataset(ds)
    si, sc = _resolve_shard(shard, shard_index, shard_count)
    return DataLoader(
        ds, batch_size, shuffle=shuffle, nbits=nbits, train=train, pad=pad,
        seed=seed, shard_index=si, shard_count=sc,
    )


@DATALOADERS.register(name="CommonDataLoader")
def CommonDataLoader(
    path: str,
    batch_size: int,
    shuffle: bool = True,
    resize=None,
    centercrop=None,
    nbits: int = 8,
    train: bool = False,
    pad=None,
    seed: int = 0,
    cache: bool = False,
    shard: bool = False,
    shard_index=None,
    shard_count=None,
) -> DataLoader:
    """ImageFolder + crop/resize loader."""
    ds = DATASETS.get("ImageFolder")(
        path, resize=resize, centercrop=centercrop
    )
    return _loader(ds, batch_size, shuffle, nbits, train, pad, seed, cache,
                   shard, shard_index, shard_count)


@DATALOADERS.register(name="CustomDataLoader")
def CustomDataLoader(
    dataset: dict,
    batch_size: int,
    shuffle: bool = True,
    nbits: int = 8,
    train: bool = False,
    pad=None,
    seed: int = 0,
    cache: bool = False,
    shard: bool = False,
    shard_index=None,
    shard_count=None,
) -> DataLoader:
    """Loader over any registered dataset by name."""
    return _loader(build(DATASETS, dataset), batch_size, shuffle, nbits,
                   train, pad, seed, cache, shard, shard_index, shard_count)

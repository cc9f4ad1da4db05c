"""Test data loader (the port's own copy of `uni_encoder_tpu/data/build.py`).

Capability spec: reference model/data/build.py (:30-121): dataset dicts
without empty-annotation filtering, an InferenceSampler that splits the
evaluation set over the ranks into contiguous shards (`inference_shard`;
a rank is a process of the torch.distributed group, `parallel/mesh.py`),
batch size 1, trivial collation. Loading overlaps compute through a bounded
thread prefetcher: the threads run the mapper (file reads, PNG decoding,
resizes) on the host only; the caller's thread is the one that uses the
card.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator, List, Optional

from .catalog import DatasetCatalog


# Items mapped ahead of the one the caller holds (and mapper threads).
PREFETCH = 4


def inference_shard(n: int, rank: int, world: int) -> range:
    """The items of rank `rank` of `world` among `n`: a contiguous shard of
    ceil(n / world) items (fewer for the last ranks; d2's InferenceSampler)."""
    shard = -(-n // world)
    begin = min(shard * rank, n)
    return range(begin, min(begin + shard, n))


def build_test_loader(dataset_name: str, mapper: Callable, rank: int = 0, world: int = 1,
                      limit: Optional[int] = None) -> "PrefetchLoader":
    """The loader of rank `rank` of `world` over `dataset_name` (its first
    `limit` items with a limit): its shard."""
    dicts = DatasetCatalog.get(dataset_name)[:limit]
    return PrefetchLoader([dicts[i] for i in inference_shard(len(dicts), rank, world)], mapper)


class PrefetchLoader:
    def __init__(self, items: List[dict], mapper: Callable):
        self.items = items
        self.mapper = mapper

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[dict]:
        if not self.items:
            return
        with cf.ThreadPoolExecutor(max_workers=PREFETCH) as pool:
            pending = []
            it = iter(self.items)
            for _ in range(PREFETCH):
                try:
                    pending.append(pool.submit(self.mapper, next(it)))
                except StopIteration:
                    break
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(self.mapper, next(it)))
                except StopIteration:
                    pass
                yield fut.result()

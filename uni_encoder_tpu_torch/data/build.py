"""Test data loader (the port's own copy of `uni_encoder_tpu/data/build.py`).

Capability spec: reference model/data/build.py (:30-121): dataset dicts
without empty-annotation filtering, batch size 1, trivial collation. The
port evaluates in one process, so there is no per-rank sampler yet
(torch.distributed waits for ROADMAP Queue 1 item 8). Loading overlaps
compute through a bounded thread prefetcher: the threads run the mapper
(file reads, PNG decoding, resizes) on the host only; the caller's thread
is the one that uses the card.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator, List

from .catalog import DatasetCatalog


# Items mapped ahead of the one the caller holds (and mapper threads).
PREFETCH = 4


def build_test_loader(dataset_name: str, mapper: Callable) -> "PrefetchLoader":
    return PrefetchLoader(list(DatasetCatalog.get(dataset_name)), mapper)


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

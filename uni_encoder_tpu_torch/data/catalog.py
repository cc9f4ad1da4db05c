"""Dataset / metadata catalogs (the port's own copy of
`uni_encoder_tpu/data/catalog.py`).

Functional equivalent of detectron2's DatasetCatalog / MetadataCatalog as
used by the reference's registration modules (model/data/datasets/*.py):
named lazy dataset loaders + attribute-style metadata records.
"""

from __future__ import annotations

import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._loaders: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, loader: Callable[[], List[dict]]) -> None:
        self._loaders[name] = loader

    def get(self, name: str) -> List[dict]:
        if name not in self._loaders:
            raise KeyError(f"dataset {name!r} not registered; known: {sorted(self._loaders)}")
        return self._loaders[name]()

    def list(self) -> List[str]:
        return sorted(self._loaders)

    def remove(self, name: str) -> None:
        self._loaders.pop(name, None)


class Metadata(types.SimpleNamespace):
    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)


class _MetadataCatalog:
    def __init__(self):
        self._meta: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._meta:
            self._meta[name] = Metadata(name=name)
        return self._meta[name]

    def list(self):
        return sorted(self._meta)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()

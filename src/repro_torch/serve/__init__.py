"""Serving layer of the port: the colocated `Engine` (aligned and
continuous batching) over the dense and paged KV stores, behind
`make_engine`."""
from repro_torch.serve.api import KVSpec, ServeConfig, make_engine
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.kvstore import DenseKVStore, PagedKVStore, make_kvstore

__all__ = [
    "DenseKVStore", "Engine", "EngineConfig", "KVSpec", "PagedKVStore", "Request",
    "ServeConfig", "make_engine", "make_kvstore",
]

"""mx.kvstore of the PyTorch port (ref: python/mxnet/kvstore/)."""
from .kvstore import KVStore, DistKVStore, StaleMembership, create

__all__ = ["KVStore", "DistKVStore", "StaleMembership", "create"]

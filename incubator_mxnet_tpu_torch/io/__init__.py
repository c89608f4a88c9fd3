"""mx.io of the PyTorch port (ref: python/mxnet/io/): the data iterators,
RecordIO, the decode service and the device feed."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,
                 LibSVMIter, ImageRecordIter, MNISTIter, ResizeIter,
                 PrefetchingIter)
from . import recordio
from .recordio import (MXRecordIO, MXIndexedRecordIO, IRHeader, pack,
                       unpack, pack_img, unpack_img)
from .resilient import RetryingReader, retry_io
from .device_feed import (DeviceFeed, feed_counters, make_normalizer,
                          normalize_transform)
from .decode_service import (DecodeService, DecodeServiceUnavailable,
                             shard_records, service_available)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ImageRecordIter", "MNISTIter", "ResizeIter",
           "PrefetchingIter", "recordio", "MXRecordIO", "MXIndexedRecordIO",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img",
           "RetryingReader", "retry_io", "DeviceFeed", "feed_counters",
           "make_normalizer", "normalize_transform", "DecodeService",
           "DecodeServiceUnavailable", "shard_records",
           "service_available"]

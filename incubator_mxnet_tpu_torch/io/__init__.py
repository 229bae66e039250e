"""Data iterators (twin of ``incubator_mxnet_tpu/io``)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, DevicePrefetchIter, CSVIter, MNISTIter,
                 ImageRecordIter, LibSVMIter, DataServiceIter)
from .sharding import shard_keys, shard_range, assigned_batches

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "CSVIter", "MNISTIter", "ImageRecordIter", "LibSVMIter",
           "DataServiceIter", "shard_keys", "shard_range",
           "assigned_batches"]

"""Data iterators (twin of ``incubator_mxnet_tpu/io``)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, DevicePrefetchIter, CSVIter, MNISTIter,
                 ImageRecordIter, LibSVMIter, DataServiceIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "CSVIter", "MNISTIter", "ImageRecordIter", "LibSVMIter",
           "DataServiceIter"]

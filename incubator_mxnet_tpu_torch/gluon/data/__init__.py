"""The Gluon data API (twin of ``incubator_mxnet_tpu/gluon/data``;
ref: python/mxnet/gluon/data/)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset", "Sampler", "SequentialSampler",
           "RandomSampler", "BatchSampler", "DataLoader",
           "default_batchify_fn", "vision"]

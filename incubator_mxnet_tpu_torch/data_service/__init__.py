"""Sharded multi-process input data service (twin of
``incubator_mxnet_tpu/data_service/``; docs/data_service.md).

``DataServiceIter`` shards a RecordIO dataset across N decode worker
processes (native ``src/imgdec`` decoder where the host can build it,
else PIL) and streams finished batches through bounded shared-memory
rings: decode scales with processes instead of sharing one
interpreter with the training loop.  With
``remote_addrs`` / ``MXTPU_DATA_REMOTE_ADDRS`` some shards decode on
OTHER hosts (``net.py``'s ``RemoteShardServer``) and stream batches
back over the framed RPC — same merge, bit-identical order.
"""
from .net import RemoteShard, RemoteShardDown, RemoteShardServer
from .ring import ShmBatchRing
from .service import DataServiceIter
from .worker import build_decode_spec

__all__ = ["DataServiceIter", "RemoteShard", "RemoteShardDown",
           "RemoteShardServer", "ShmBatchRing", "build_decode_spec"]

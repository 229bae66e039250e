"""Serving-fleet RPC (twin of ``incubator_mxnet_tpu/serving/rpc.py``):
the fleet's import surface over the shared transport,
``incubator_mxnet_tpu_torch/rpc.py``, whose frames are byte-equal to the
JAX package's.  The default fault-injection scope on every send path is
``router:net``.
"""
from ..rpc import (MAGIC, MAX_FRAME_BYTES, DEFAULT_FAULT_SCOPE,
                   RpcClient, RpcError, RpcFrameError, RpcServer,
                   RpcTimeoutError, default_timeout, encode_frame,
                   logger, recv_frame, send_frame)
from ..rpc import _HEADER, _Conn, _deadline, _recv_exact, _remaining

#: names kept importable for transport internals users (tests build
#: raw frames via "_HEADER", the router pools "_Conn" handles, and
#: deadline math reuses "_deadline" / "_remaining" / "_recv_exact")
_PRIVATE_REEXPORTS = ("_HEADER", "_Conn", "_deadline",
                      "_recv_exact", "_remaining")

__all__ = ["MAGIC", "MAX_FRAME_BYTES", "DEFAULT_FAULT_SCOPE",
           "RpcClient", "RpcError", "RpcFrameError", "RpcServer",
           "RpcTimeoutError", "default_timeout", "encode_frame",
           "logger", "recv_frame", "send_frame"]

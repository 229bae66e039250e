"""The serving tier (twin of ``incubator_mxnet_tpu/serving/``):
continuous batching over a paged KV cache, prefix caching and int8
weights over ``TransformerLM``.

    from incubator_mxnet_tpu_torch import serving
    eng = serving.ServingEngine(model, max_batch=8)
    req = eng.submit(prompt_tokens, max_new_tokens=64)
    for r, tok in eng.stream():
        ...

On a CUDA model the decode step runs as one captured CUDA graph per
engine; on a CPU model (``device="cpu"``) it runs eagerly.

Multi-replica fleet: ``ServingRouter`` spreads requests over N
``ReplicaServer`` processes speaking the ``rpc`` frame protocol (the JAX
package's frames), with prefix-affinity routing, circuit breakers, and
failover re-dispatch.  A replica process:
``python -m incubator_mxnet_tpu_torch.serving.replica --tiny SPEC``.
"""
from .block_table import BlockPool, BlockPoolExhausted
from .cache_manager import PrefixCache
from .engine import ServingEngine
from .quantize import (quantization_error, quantize_weights,
                       weights_nbytes)
from .replica import ReplicaServer
from .router import FleetRequest, ServingRouter
from .rpc import (RpcClient, RpcError, RpcFrameError, RpcServer,
                  RpcTimeoutError)
from .scheduler import (CANCELLED, EXPIRED, FAILED, FINISHED, QUEUED,
                        RUNNING, TERMINAL_STATES, Request,
                        RequestTooLargeError, Scheduler,
                        SchedulingError, ServeRejectedError,
                        ServingError)

__all__ = ["ServingEngine", "BlockPool", "BlockPoolExhausted",
           "PrefixCache", "Request", "Scheduler", "ServingError",
           "SchedulingError", "ServeRejectedError",
           "RequestTooLargeError", "quantize_weights",
           "quantization_error", "weights_nbytes", "QUEUED",
           "RUNNING", "FINISHED", "FAILED", "EXPIRED", "CANCELLED",
           "TERMINAL_STATES", "ServingRouter", "FleetRequest",
           "ReplicaServer", "RpcClient", "RpcServer", "RpcError",
           "RpcTimeoutError", "RpcFrameError"]

"""``graph``: the optimization layer between Symbol and Executor (twin
of ``incubator_mxnet_tpu/graph/``).

A pass pipeline over the symbolic ``_Node`` IR plus :class:`CachedOp`,
the trace-once replay cache behind ``HybridBlock.hybridize()``.
``Executor`` binds every graph that is not placed through
:func:`optimize_symbol` under ``MXTPU_GRAPH_OPT`` (0 = off, 1 = safe
passes, 2 = + elementwise pre-fusion).
"""
from .ir import Graph
from .passes import (GraphPass, PassManager, PASSES, register_pass,
                     default_pass_names, optimize_symbol, CONST_OP)
from .fuse import FusedOp, FuseElemwise, ELEMWISE_OPS
from .cached_op import CachedOp, UnsupportedSignatureError

__all__ = ["Graph", "GraphPass", "PassManager", "PASSES",
           "register_pass", "default_pass_names", "optimize_symbol",
           "CONST_OP", "FusedOp", "FuseElemwise", "ELEMWISE_OPS",
           "CachedOp", "UnsupportedSignatureError"]

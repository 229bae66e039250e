"""Perf observatory: analytic graph cost model, device capability
DB, roofline/MFU attribution, device-memory planner (twin of
``incubator_mxnet_tpu/perf``).

    from incubator_mxnet_tpu_torch import perf
    report = perf.symbol_cost(sym, {"data": (32, 784)})
    rows = report.table(perf.caps_for_kind("NVIDIA H100 80GB HBM3"))
    plan = perf.plan_memory(sym, {"data": (32, 784)})
"""
from .cost_model import (CostReport, DEFAULT_COST, ZERO_COST,
                         counted_cost, coverage_gaps, covered_ops,
                         jit_cost, symbol_cost,
                         transformer_decode_cost,
                         transformer_decode_flops_per_token,
                         transformer_train_flops_per_token)
from .device_db import (DEVICE_DB, DeviceCaps, caps_for,
                        caps_for_kind, hbm_capacity, headroom,
                        peak_flops, roofline)
from .clock import TrainPerfClock
from .memory_planner import (MemoryPlan, PreflightResult,
                             cuda_live_bytes, dispatch_liveness,
                             max_leaf_bytes, next_divisor, plan_memory,
                             preflight, sharded_tree_bytes,
                             symbol_liveness, tree_bytes)

__all__ = [
    "CostReport", "DEFAULT_COST", "ZERO_COST", "counted_cost",
    "coverage_gaps", "covered_ops", "jit_cost", "symbol_cost",
    "transformer_decode_cost", "transformer_decode_flops_per_token",
    "transformer_train_flops_per_token",
    "DEVICE_DB", "DeviceCaps", "caps_for", "caps_for_kind",
    "hbm_capacity", "headroom", "peak_flops", "roofline",
    "TrainPerfClock",
    "MemoryPlan", "PreflightResult", "cuda_live_bytes", "dispatch_liveness",
    "max_leaf_bytes", "next_divisor", "plan_memory", "preflight",
    "sharded_tree_bytes", "symbol_liveness", "tree_bytes",
]

"""Analytic graph cost model: per-op FLOPs and bytes-moved formulas
over the symbolic IR (twin of ``incubator_mxnet_tpu/perf/cost_model.py``;
the formulas and tables are the JAX package's, copied).

``symbol_cost(symbol, shapes)`` walks the graph the way the port's shape
inference does (``Symbol._infer_shape_impl``): each node's own op runs
on ``meta`` tensors, so every node gets concrete input and output shapes
and dtypes, where the JAX walk calls ``jax.eval_shape``.  A closed-form
FLOP formula keyed on the op's canonical registry name is applied and
summed into per-family totals, arithmetic intensity and a coverage
report.

Conventions (every number below follows them):

- FLOPs are *forward* multiply-add-counted-as-2 (a matmul m.n.k is
  ``2mnk``).  A train step is modeled as ``3x`` forward (fwd + bwd
  ~= 2x fwd), applied by the caller via ``CostReport.scaled(3)``.
- Bytes-moved is the sum of input bytes + output bytes per op, with
  per-op overrides where that is badly wrong (gather ops read only the
  gathered rows, not the whole table).
- ``ZERO_COST`` ops are metadata/copy ops: zero FLOPs, default bytes.
- ``DEFAULT_COST`` ops carry a documented reason why no closed form
  exists; they (and any op missing from every table) cost 1 FLOP per
  output element and count into the report's coverage section plus the
  ``perf_uncovered_ops_total`` telemetry counter.

The JAX package cross-checks the model against XLA: ``xla_cost`` reads a
compiled executable's ``cost_analysis()`` and ``jit_cost(fn, *avals)``
compiles ``fn`` to ask it.  Eager torch compiles nothing to ask, so the
port counts instead: :func:`counted_cost` (in ``xla_cost``'s place) runs
``fn`` once under ``torch.utils.flop_counter.FlopCounterMode``, on
``meta`` or real tensors, and sums every aten op's input and output
bytes beside it; ``jit_cost(fn, *args)`` keeps its name and meaning (the
counted cost of one call of ``fn``, or None where the call fails).
FlopCounterMode counts the products (matmuls, convolutions, attention)
and nothing elementwise.
"""
import math

__all__ = ["symbol_cost", "CostReport", "covered_ops",
           "coverage_gaps", "ZERO_COST", "DEFAULT_COST",
           "counted_cost", "jit_cost",
           "transformer_train_flops_per_token",
           "transformer_decode_flops_per_token",
           "transformer_decode_cost"]


def _prod(shape):
    out = 1
    for d in shape:
        out *= int(d)
    return float(out)


# ------------------------------------------------------------------ tables
# canonical op name -> (family, flops_fn(in_shapes, out_shapes,
# params) -> float).  Bytes overrides live in _BYTES.
_FAMILY = {}
_FLOPS = {}
_BYTES = {}


def _register(name, family, flops_fn, bytes_fn=None):
    _FAMILY[name] = family
    _FLOPS[name] = flops_fn
    if bytes_fn is not None:
        _BYTES[name] = bytes_fn


def _ew(factor):
    """Elementwise: ``factor`` FLOPs per output element."""
    return lambda i, o, p: factor * sum(_prod(s) for s in o)


def _red(factor=1.0):
    """Reduction: ``factor`` FLOPs per *input* element."""
    return lambda i, o, p: factor * _prod(i[0])


def _nlogn(i, o, p):
    n = _prod(i[0])
    return n * max(1.0, math.log2(max(n, 2.0)))


# --- elementwise: unary transcendental factors (rough instruction
# counts on a vector unit; 1 is the default for cheap arithmetic)
_UNARY_FACTORS = {
    "exp": 4, "expm1": 4, "log": 4, "log10": 4, "log1p": 4,
    "log2": 4, "sin": 8, "cos": 8, "tan": 8, "sinh": 8, "cosh": 8,
    "tanh": 8, "arccos": 8, "arccosh": 8, "arcsin": 8, "arcsinh": 8,
    "arctan": 8, "arctanh": 8, "erf": 10, "erfinv": 10, "gamma": 10,
    "gammaln": 10, "sqrt": 2, "rsqrt": 2, "cbrt": 2, "rcbrt": 2,
    "sigmoid": 4, "softrelu": 4, "softsign": 2, "smooth_l1": 3,
    "clip": 2, "square": 1, "abs": 1, "sign": 1, "negative": 1,
    "reciprocal": 1, "ceil": 1, "floor": 1, "rint": 1, "round": 1,
    "fix": 1, "trunc": 1, "degrees": 1, "radians": 1,
    "logical_not": 1, "relu": 1, "where": 1, "elemwise_addto": 1,
    "add_n": 1,
}
for _n, _f in _UNARY_FACTORS.items():
    _register(_n, "elementwise", _ew(_f))

# binary broadcast / comparison / scalar ops: 1 FLOP per element
_EW_1X = [
    "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_div", "broadcast_power", "broadcast_maximum",
    "broadcast_minimum", "broadcast_mod", "broadcast_hypot",
    "broadcast_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_not_equal", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor",
    "_equal", "_greater", "_greater_equal", "_lesser",
    "_lesser_equal", "_not_equal",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
    "_power_scalar", "_rpower_scalar", "_hypot_scalar",
    "_maximum_scalar", "_minimum_scalar",
    "_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
    "_lesser_scalar", "_lesser_equal_scalar", "_not_equal_scalar",
    "_scatter_plus_scalar", "_scatter_minus_scalar",
    "_scatter_elemwise_div",
    "_contrib_quantize", "_contrib_dequantize",
    "SequenceMask", "IdentityAttachKLSparseReg",
]
for _n in _EW_1X:
    _register(_n, "elementwise", _ew(1))

_register("Activation", "elementwise", _ew(2))
_register("LeakyReLU", "elementwise", _ew(2))
_register("softmax", "elementwise", _red(5))
_register("log_softmax", "elementwise", _red(5))
_register("SoftmaxOutput", "elementwise", _red(5))
_register("softmax_cross_entropy", "elementwise", _red(5))
_register("LinearRegressionOutput", "elementwise", _red(3))
_register("MAERegressionOutput", "elementwise", _red(3))
_register("LogisticRegressionOutput", "elementwise", _red(4))
_register("SVMOutput", "elementwise", _red(4))
_register("make_loss", "elementwise", _ew(0))

# --- reductions
for _n in ("sum", "mean", "max", "min", "prod", "nansum", "nanprod",
           "argmax", "argmin", "argmax_channel", "cumsum"):
    _register(_n, "reduction", _red(1))
_register("norm", "reduction", _red(2))
_register("_square_sum", "reduction", _red(2))
_register("_linalg_sumlogdiag", "reduction",
          lambda i, o, p: 10.0 * i[0][-1])
for _n in ("sort", "argsort", "topk"):
    _register(_n, "reduction", _nlogn)


# --- matmul family
def _fc_flops(i, o, p):
    # weight is (num_hidden, input_units); out rows = batch elements
    w = i[1]
    return 2.0 * _prod(o[0]) * w[-1] + _prod(o[0])


def _dot_flops(i, o, p):
    lhs = i[0]
    k = lhs[0] if p.get("transpose_a") else lhs[-1]
    return 2.0 * _prod(o[0]) * k


def _batch_dot_flops(i, o, p):
    lhs = i[0]
    k = lhs[-2] if p.get("transpose_a") else lhs[-1]
    return 2.0 * _prod(o[0]) * k


def _einsum_flops(i, o, p):
    eq = str(p.get("subscripts", ""))
    lhs = eq.split("->")[0]
    terms = [t.strip() for t in lhs.split(",")]
    if len(terms) != len(i):
        return None
    dims = {}
    for t, s in zip(terms, i):
        if "." in t or len(t) != len(s):
            return None        # ellipsis etc.: fall to default
        for ch, d in zip(t, s):
            dims[ch] = max(dims.get(ch, 1), int(d))
    total = 1.0
    for d in dims.values():
        total *= d
    return 2.0 * total


def _gemm_flops(i, o, p):
    m, n = o[0][-2], o[0][-1]
    a = i[0]
    k = a[-2] if p.get("transpose_a") else a[-1]
    batch = _prod(o[0][:-2])
    return batch * (2.0 * m * n * k)


def _rnn_flops(i, o, p):
    gates = {"lstm": 4, "gru": 3}.get(str(p.get("mode", "lstm")), 1)
    data = i[0]                       # (T, B, I)
    t, b, inp = data[0], data[1], data[-1]
    h = int(p.get("state_size", 0)) or inp
    layers = int(p.get("num_layers", 1))
    dirs = 2 if p.get("bidirectional") else 1
    per_t = gates * h * ((inp + h) + max(0, layers - 1)
                         * (dirs * h + h))
    return 2.0 * t * b * dirs * per_t


def _moe_flops(i, o, p):
    data, router = i[0], i[1]
    t, d = _prod(data[:-1]), data[-1]
    e = router[-1] if router[-1] != d else router[0]
    hid = _prod(i[2]) / max(1.0, float(e) * d)
    # top-2 gating: router matmul + two experts' up+down per token
    return 2.0 * t * d * e + 8.0 * t * d * hid


_register("FullyConnected", "matmul", _fc_flops)
_register("dot", "matmul", _dot_flops)
_register("batch_dot", "matmul", _batch_dot_flops)
_register("einsum", "matmul", _einsum_flops)
_register("khatri_rao", "matmul",
          lambda i, o, p: 2.0 * _prod(o[0]))
_register("_linalg_gemm", "matmul",
          lambda i, o, p: _gemm_flops(i, o, p) + 2.0 * _prod(o[0]))
_register("_linalg_gemm2", "matmul", _gemm_flops)
_register("_linalg_syrk", "matmul",
          lambda i, o, p: _prod(i[0]) * i[0][-2])
_register("_linalg_trmm", "matmul",
          lambda i, o, p: _prod(o[0]) * i[0][-1])
_register("_linalg_trsm", "matmul",
          lambda i, o, p: _prod(o[0]) * i[0][-1])
_register("_linalg_potrf", "matmul",
          lambda i, o, p: _prod(i[0]) * i[0][-1] / 3.0)
_register("_linalg_potri", "matmul",
          lambda i, o, p: 2.0 * _prod(i[0]) * i[0][-1] / 3.0)
_register("_linalg_gelqf", "matmul",
          lambda i, o, p: 2.0 * _prod(i[0]) * i[0][-1])
_register("_linalg_syevd", "matmul",
          lambda i, o, p: 9.0 * _prod(i[0]) * i[0][-1])
_register("RNN", "matmul", _rnn_flops)
_register("_moe_ffn", "matmul", _moe_flops)
_register("_contrib_fft", "other",
          lambda i, o, p: 5.0 * _prod(i[0])
          * math.log2(max(i[0][-1], 2)))
_register("_contrib_ifft", "other",
          lambda i, o, p: 5.0 * _prod(i[0])
          * math.log2(max(i[0][-1], 2)))


# --- conv family
def _conv_flops(i, o, p):
    # weight (C_out, C_in/groups, *kernel): each output element costs
    # 2 * C_in/groups * prod(kernel)
    w = i[1]
    return 2.0 * _prod(o[0]) * _prod(w[1:])


def _deconv_flops(i, o, p):
    # transposed conv: every INPUT element fans out through the kernel
    w = i[1]
    return 2.0 * _prod(i[0]) * _prod(w[1:])


_register("Convolution", "conv", _conv_flops)
_register("Deconvolution", "conv", _deconv_flops)
_register("_contrib_DeformableConvolution", "conv", _conv_flops)


# --- attention family
def _flash_flops(i, o, p):
    # q/k/v: (B*H, L, D); banded (window > 0) skips dead blocks, so
    # the attended span per query is min(L, window) — the same
    # ``att_span`` convention as transformer.train_flops_per_token
    q = i[0]
    bh, length, d = q[0], q[1], q[2]
    window = int(p.get("window", 0) or 0)
    span = min(length, window) if window > 0 else length
    return 4.0 * bh * length * span * d     # QK^T + att@V matmuls


_register("_flash_attention", "attention", _flash_flops)
_register("_rope", "attention", _ew(4))


# --- norm family
for _n, _f in (("BatchNorm", 8), ("LayerNorm", 8),
               ("InstanceNorm", 8), ("L2Normalization", 4),
               ("LRN", 10)):
    _register(_n, "norm", _red(_f))


# --- embedding / gather family: ~zero FLOPs; bytes touch only the
# gathered rows + indices + output, never the whole table
def _gather_bytes(i, o, p, in_bytes, out_bytes):
    idx_bytes = in_bytes[0] if len(in_bytes) > 1 else 0.0
    return idx_bytes + 2.0 * sum(out_bytes)


for _n in ("Embedding", "take", "batch_take", "pick", "gather_nd",
           "one_hot", "scatter_nd", "_scatter_set_nd",
           "_sparse_retain"):
    _register(_n, "embedding", _ew(0), _gather_bytes)


# --- pooling and samplers (family "other")
def _pool_flops(i, o, p):
    if p.get("global_pool"):
        return _prod(i[0])
    return _prod(o[0]) * max(1.0, _prod(p.get("kernel", ()) or ()))


_register("Pooling", "other", _pool_flops)
_register("UpSampling", "other", _ew(1))
_register("BilinearSampler", "other", _ew(8))
_register("GridGenerator", "other", _ew(6))
_register("SpatialTransformer", "other", _ew(8))

# --- random family
for _n in ("_random_exponential", "_random_gamma",
           "_random_generalized_negative_binomial",
           "_random_negative_binomial", "_random_normal",
           "_random_poisson", "_random_randint", "_random_uniform",
           "_sample_exponential", "_sample_gamma",
           "_sample_multinomial", "_sample_normal", "_sample_poisson",
           "_sample_uniform"):
    _register(_n, "random", _ew(10))
_register("Dropout", "random", _ew(3))
_register("_shuffle", "random", _ew(1))

# --- optimizer update ops (bench graphs fuse the update into the
# step graph; ~6 FLOPs per parameter element covers sgd..adam)
for _n in ("sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "ftrl_update",
           "rmsprop_update", "rmspropalex_update", "signsgd_update",
           "signum_update"):
    _register(_n, "optimizer", _red(6))

# --- zero-cost: metadata, layout, copies, and constant initializers.
# Zero FLOPs; bytes follow the default in+out rule (a transpose or
# concat still moves its tensors).
ZERO_COST = {
    "Reshape", "Flatten", "expand_dims", "squeeze", "reshape_like",
    "transpose", "SwapAxis", "slice", "slice_axis", "slice_like",
    "Crop", "SliceChannel", "Concat", "stack", "tile", "repeat",
    "reverse", "broadcast_to", "broadcast_axis", "broadcast_like",
    "Pad", "BlockGrad", "_copy", "_CrossDeviceCopy",
    "_identity_with_attr_like_rhs", "_NDArray", "Cast", "amp_cast",
    "cast_storage", "_arange", "_eye", "_full", "_ones", "_zeros",
    "ones_like", "zeros_like", "SequenceLast", "SequenceReverse",
    "_slice_assign", "_slice_assign_scalar",
}

# --- documented defaults: no closed form exists; the reason string
# documents why the op has no formula.
DEFAULT_COST = {
    "Custom": "user-defined op; cost unknowable statically",
    "_Native": "user-defined native op; cost unknowable statically",
    "Correlation": "patch-correlation cost depends on displacement "
                   "grid; modeled as 1 FLOP/output element",
    "ROIPooling": "data-dependent pooling windows (per-ROI extents)",
    "_contrib_PSROIPooling": "data-dependent pooling windows",
    "_contrib_DeformablePSROIPooling": "data-dependent sampling grid",
    "_contrib_MultiBoxPrior": "anchor generation; negligible, "
                              "data-shaped",
    "_contrib_MultiBoxDetection": "NMS cost depends on score "
                                  "distribution",
    "_contrib_MultiBoxTarget": "matching cost depends on label count",
    "_contrib_MultiProposal": "NMS cost depends on score "
                              "distribution",
    "_contrib_Proposal": "NMS cost depends on score distribution",
    "_contrib_count_sketch": "hash-projection cost is index-driven",
    "ctc_loss": "dynamic-programming cost depends on label lengths",
}

_ALL_FAMILIES = ("matmul", "conv", "attention", "norm", "elementwise",
                 "reduction", "embedding", "random", "optimizer",
                 "shape", "other")


def covered_ops():
    """Every canonical op name the model covers (formula, zero-cost,
    or documented default) — the set the op registry is checked
    against."""
    return set(_FAMILY) | ZERO_COST | set(DEFAULT_COST)


def coverage_gaps(op_names):
    """Registry names with no cost entry (must be empty)."""
    cov = covered_ops()
    return sorted(n for n in op_names if n not in cov)


# ------------------------------------------------------------------ report
class CostReport:
    """Aggregated cost of one graph at fixed shapes."""

    def __init__(self, per_family, flops, bytes_moved, coverage,
                 default_ops, unknown_ops, n_nodes):
        self.per_family = per_family      # family -> {flops, bytes, ops}
        self.flops = flops
        self.bytes = bytes_moved
        self.coverage = coverage          # {modeled, zero, default, unknown}
        self.default_ops = default_ops
        self.unknown_ops = unknown_ops
        self.n_nodes = n_nodes

    @property
    def arithmetic_intensity(self):
        return self.flops / self.bytes if self.bytes else 0.0

    def scaled(self, k):
        """Same graph run ``k`` times (train step ~= 3x forward)."""
        fams = {f: {"flops": v["flops"] * k, "bytes": v["bytes"] * k,
                    "ops": v["ops"]}
                for f, v in self.per_family.items()}
        return CostReport(fams, self.flops * k, self.bytes * k,
                          dict(self.coverage), list(self.default_ops),
                          list(self.unknown_ops), self.n_nodes)

    def summary(self):
        """Compact dict for the compile ledger / JSON artifacts."""
        return {"gflops": round(self.flops / 1e9, 3),
                "gbytes": round(self.bytes / 1e9, 3),
                "arithmetic_intensity":
                    round(self.arithmetic_intensity, 2)}

    def table(self, caps, dtype="float32"):
        """Per-family roofline table: flops%, bytes%, predicted-time%
        against a DeviceCaps, bound-by label per family."""
        from .device_db import roofline
        rows = []
        times = {}
        for fam, v in sorted(self.per_family.items()):
            rl = roofline(v["flops"], v["bytes"], caps, dtype)
            times[fam] = rl["predicted_s"]
        t_total = sum(times.values()) or 1.0
        for fam, v in sorted(self.per_family.items(),
                             key=lambda kv: -kv[1]["flops"]):
            rl = roofline(v["flops"], v["bytes"], caps, dtype)
            rows.append({
                "family": fam, "ops": v["ops"],
                "gflops": round(v["flops"] / 1e9, 3),
                "gbytes": round(v["bytes"] / 1e9, 3),
                "flops_pct": round(100.0 * v["flops"]
                                   / (self.flops or 1.0), 1),
                "bytes_pct": round(100.0 * v["bytes"]
                                   / (self.bytes or 1.0), 1),
                "predicted_time_pct":
                    round(100.0 * rl["predicted_s"] / t_total, 1),
                "bound": rl["bound"],
                "arithmetic_intensity":
                    round(rl["arithmetic_intensity"], 2)})
        return rows


# ------------------------------------------------------------------ walk
def _itemsize(dt):
    return float(dt.itemsize)


def symbol_cost(symbol, shapes=None, dtypes=None):
    """Cost a Symbol graph at concrete input shapes.

    ``shapes``: dict of variable name -> shape for (at least) the
    data inputs; parameter shapes missing from it are recovered via
    ``infer_shape_partial`` (the shape-hook machinery).  Returns a
    :class:`CostReport` of ONE forward pass.
    """
    from .. import telemetry
    from ..base import torch_dtype
    from ..symbol.symbol import _meta_run, _topo

    shapes = dict(shapes or {})
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    known = {k: v for k, v in shapes.items()
             if k in set(arg_names) | set(aux_names)}
    arg_shapes, _, aux_shapes = symbol.infer_shape_partial(**known)
    for nm, s in list(zip(arg_names, arg_shapes)) \
            + list(zip(aux_names, aux_shapes)):
        if s is not None and nm not in shapes:
            shapes[nm] = tuple(s)

    order = _topo(symbol._heads)
    avals = {}          # (id(node), idx) -> (shape, torch dtype)
    fam_agg = {}
    n_default = n_zero = n_modeled = n_unknown = 0
    default_ops, unknown_ops = set(), set()
    total_flops = total_bytes = 0.0
    n_nodes = 0

    for node in order:
        if node.is_variable:
            if node.name in shapes:
                dt = torch_dtype((dtypes or {}).get(
                    node.name, node.attrs.get("__dtype__", "float32")))
                avals[(id(node), 0)] = (tuple(shapes[node.name]), dt)
            continue
        in_keys = [(id(n), i) for n, i in node.inputs]
        if any(k not in avals for k in in_keys):
            raise ValueError(
                f"symbol_cost: unknown input shape at op "
                f"'{node.op.name}' (node '{node.name}') — pass "
                "shapes for all data variables")
        in_shapes = [avals[k][0] for k in in_keys]
        in_dtypes = [avals[k][1] for k in in_keys]
        outs = _meta_run(node, in_shapes, in_dtypes)
        out_shapes, out_dtypes = [], []
        for i, o in enumerate(outs):
            avals[(id(node), i)] = (tuple(o.shape), o.dtype)
            out_shapes.append(tuple(o.shape))
            out_dtypes.append(o.dtype)

        name = node.op.name
        in_bytes = [_prod(s) * _itemsize(d)
                    for s, d in zip(in_shapes, in_dtypes)]
        out_bytes = [_prod(s) * _itemsize(d)
                     for s, d in zip(out_shapes, out_dtypes)]
        if name in ZERO_COST:
            family, flops = "shape", 0.0
            n_zero += 1
        elif name in _FLOPS:
            family = _FAMILY[name]
            flops = _FLOPS[name](in_shapes, out_shapes, node.params)
            if flops is None:       # formula punted (einsum ellipsis)
                flops = sum(_prod(s) for s in out_shapes)
            n_modeled += 1
        else:
            family = "other"
            flops = sum(_prod(s) for s in out_shapes)
            if name in DEFAULT_COST:
                n_default += 1
                default_ops.add(name)
            else:
                n_unknown += 1
                unknown_ops.add(name)
                telemetry.counter("perf_uncovered_ops_total").inc()
        if name in _BYTES:
            byts = _BYTES[name](in_shapes, out_shapes, node.params,
                                in_bytes, out_bytes)
        else:
            byts = sum(in_bytes) + sum(out_bytes)
        agg = fam_agg.setdefault(family,
                                 {"flops": 0.0, "bytes": 0.0,
                                  "ops": 0})
        agg["flops"] += flops
        agg["bytes"] += byts
        agg["ops"] += 1
        total_flops += flops
        total_bytes += byts
        n_nodes += 1

    coverage = {"modeled": n_modeled, "zero": n_zero,
                "default": n_default, "unknown": n_unknown}
    return CostReport(fam_agg, total_flops, total_bytes, coverage,
                      sorted(default_ops), sorted(unknown_ops),
                      n_nodes)


# ---------------------------------------------------------- counted cost
def _tensor_bytes(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0.0


def _byte_counter():
    """A dispatch mode summing every aten op's input and output bytes
    (each tensor an op reads or writes counted once per op)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.bytes += _tensor_bytes(list(args)) \
                + _tensor_bytes(kwargs or {}) + _tensor_bytes(out)
            return out

    return ByteCounter()


def counted_cost(fn, *args):
    """``{"flops", "bytes"}`` of one call ``fn(*args)`` (on ``meta`` or
    real tensors): FLOPs by ``FlopCounterMode`` (products only), bytes
    as every aten op's inputs plus outputs.  The port's counterpart of
    the JAX package's ``xla_cost`` (the module docstring says why)."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    nbytes = _byte_counter()
    with flops, nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes)}


def jit_cost(fn, *args):
    """The counted cost of one call ``fn(*args)`` (:func:`counted_cost`),
    or None when the call fails."""
    try:
        return counted_cost(fn, *args)
    except Exception:
        return None


# ------------------------------------------- analytic transformer cost
def _transformer_dims(d_model, n_heads, n_kv_heads, mlp_ratio):
    n_kv = n_kv_heads or n_heads
    kv_d = d_model * n_kv // n_heads
    hid = int(d_model * mlp_ratio)
    return kv_d, hid


def transformer_train_flops_per_token(
        d_model, n_layers, vocab, seq_len, n_heads, n_kv_heads=None,
        mlp_ratio=4, attn_window=0, moe_experts=0):
    """Closed-form train FLOPs/token for the TransformerLM family —
    the same primitive formulas as the graph pass (qkv/proj/mlp
    matmuls at 2mnk, attention at 2 x 2 x att_span x d), times 3 for
    fwd+bwd.  ``transformer.train_flops_per_token`` is asserted
    against this (+-2%) by bench.py."""
    kv_d, hid = _transformer_dims(d_model, n_heads, n_kv_heads,
                                  mlp_ratio)
    att_span = min(seq_len, attn_window) if attn_window else seq_len
    per_layer = (2 * d_model * (d_model + 2 * kv_d)    # qkv proj
                 + 2 * d_model * d_model               # out proj
                 + 2 * 2 * att_span * d_model)         # scores + att@v
    if moe_experts:
        per_layer += (2 * 2 * (2 * d_model * hid)      # top-2 experts
                      + 2 * d_model * moe_experts)     # router
    else:
        per_layer += 2 * 2 * d_model * hid             # dense mlp
    fwd = n_layers * per_layer + 2 * d_model * vocab   # + lm head
    return 3 * fwd


def transformer_decode_flops_per_token(
        d_model, n_layers, vocab, context_len, n_heads,
        n_kv_heads=None, mlp_ratio=4, attn_window=0, moe_experts=0):
    """Forward FLOPs to decode ONE token at a given KV-cache length
    (attention span = min(context, window); no backward)."""
    kv_d, hid = _transformer_dims(d_model, n_heads, n_kv_heads,
                                  mlp_ratio)
    span = min(context_len, attn_window) if attn_window \
        else context_len
    per_layer = (2 * d_model * (d_model + 2 * kv_d)
                 + 2 * d_model * d_model
                 + 2 * 2 * span * d_model)
    if moe_experts:
        per_layer += (2 * 2 * (2 * d_model * hid)
                      + 2 * d_model * moe_experts)
    else:
        per_layer += 2 * 2 * d_model * hid
    return n_layers * per_layer + 2 * d_model * vocab


def transformer_decode_cost(
        d_model, n_layers, vocab, context_len, n_heads,
        n_kv_heads=None, mlp_ratio=4, attn_window=0, moe_experts=0,
        batch=1, dtype_size=4):
    """Per-family CostReport for one batched decode step (the serving
    engine's unit of work): matmul / attention / embedding split with
    bytes dominated by weight + KV-cache streaming."""
    kv_d, hid = _transformer_dims(d_model, n_heads, n_kv_heads,
                                  mlp_ratio)
    span = min(context_len, attn_window) if attn_window \
        else context_len
    b = float(batch)
    mm_flops = b * n_layers * (
        2 * d_model * (d_model + 2 * kv_d) + 2 * d_model * d_model
        + (2 * 2 * (2 * d_model * hid) + 2 * d_model * moe_experts
           if moe_experts else 2 * 2 * d_model * hid))
    att_flops = b * n_layers * 2 * 2 * span * d_model
    emb_flops = b * 2 * d_model * vocab
    # decode is weight-streaming: every weight read once per step,
    # plus the live KV window per layer, plus the logits row
    n_experts_live = 2 if moe_experts else 1
    w_bytes = n_layers * (
        d_model * (d_model + 2 * kv_d) + d_model * d_model
        + n_experts_live * 2 * d_model * hid) * dtype_size \
        + d_model * vocab * dtype_size
    kv_bytes = b * n_layers * 2 * span * kv_d * dtype_size
    emb_bytes = b * vocab * dtype_size
    fams = {
        "matmul": {"flops": mm_flops, "bytes": float(w_bytes),
                   "ops": 4 * n_layers},
        "attention": {"flops": att_flops, "bytes": float(kv_bytes),
                      "ops": n_layers},
        "embedding": {"flops": emb_flops, "bytes": float(emb_bytes),
                      "ops": 1},
    }
    flops = mm_flops + att_flops + emb_flops
    byts = float(w_bytes + kv_bytes + emb_bytes)
    return CostReport(fams, flops, byts,
                      {"modeled": 6 * n_layers + 1, "zero": 0,
                       "default": 0, "unknown": 0},
                      [], [], 6 * n_layers + 1)

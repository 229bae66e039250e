"""User kernels in CUDA C++ as first-class ops (twin of
``incubator_mxnet_tpu/rtc.py``).

MXNet's ``mx.rtc`` took a CUDA kernel as source text and launched it on
a grid; the JAX package made the same role a Pallas kernel.  The port
restores MXNet's shape:

``compile_kernel``
    a ``__global__`` kernel as source text, its C parameter list, a
    grid and a block.  At first use on a CUDA tensor the source is
    built with ``nvcc`` for ``sm_90a`` (``ops/_build.build_source``)
    together with a generated C launcher, bound with ``ctypes``, and
    launched on PyTorch's current stream.  CPU tensors run the plain
    PyTorch version the user supplies (``reference``): the counterpart
    of Pallas interpret mode, which cannot exist for CUDA source.

``register``
    puts any function on torch tensors (a compiled kernel, or plain
    PyTorch) into the op registry and onto ``nd`` and ``sym``,
    optionally with a custom VJP, which becomes a
    ``torch.autograd.Function``.  A bound Symbol's executor calls the
    op's function as any other op's, so the kernel launches once per
    forward of the graph.  On ``meta`` tensors (the symbolic shape
    inference) a kernel returns empty outputs of its ``out_shape`` and
    launches nothing.

Example (the kernels of ``rtc_examples.py`` are built this way)::

    src = '''
    __global__ void my_scale(const float* x, float* o, float alpha,
                             long long n) {
      for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
           i < n; i += (long long)gridDim.x * blockDim.x)
        o[i] = x[i] * alpha;
    }'''
    fn = rtc.compile_kernel(
        src, "my_scale", "const float* x, float* o, float alpha, long long n",
        out_shape=lambda x, **p: rtc.ShapeDtype(x.shape, x.dtype),
        grid=lambda x, **p: ((x.numel() + 255) // 256,),
        scalars=lambda x, **p: {"n": x.numel()},
        reference=lambda x, alpha: x * alpha)
    rtc.register("my_scale", fn, arg_names=["data"],
                 vjp=(lambda x, alpha=2.0: (fn(x, alpha=alpha), None),
                      lambda alpha, res, g: (g * alpha,)))
    y = mt.nd.my_scale(mt.nd.ones((4, 4)), alpha=3.0)
"""
import collections
import ctypes
import functools
import inspect
import re
import warnings

import torch

from .base import MXNetError, torch_dtype
from .ops import _build
from .ops.registry import OPS, OpDef

__all__ = ["ShapeDtype", "compile_kernel", "register", "unregister",
           "on_gpu", "parse_signature", "launcher_source"]

ShapeDtype = collections.namedtuple("ShapeDtype", "shape dtype")
ShapeDtype.__doc__ = """Shape and dtype of one output (the role of
``jax.ShapeDtypeStruct``)."""

Param = collections.namedtuple("Param", "text name base pointer")

# scalar C types the launcher passes, with their ctypes
SCALAR_TYPES = {"float": ctypes.c_float, "double": ctypes.c_double,
                "int": ctypes.c_int, "long long": ctypes.c_longlong,
                "int64_t": ctypes.c_longlong}
# pointee C types and the tensor dtype each takes (None: any)
POINTER_TYPES = {"float": torch.float32, "double": torch.float64,
                 "int": torch.int32, "long long": torch.int64,
                 "int64_t": torch.int64, "__nv_bfloat16": torch.bfloat16,
                 "__half": torch.float16, "half": torch.float16,
                 "void": None}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict"}
_IDENT = re.compile(r"[A-Za-z_]\w*")


def on_gpu():
    """True when a CUDA card is present (twin of ``on_tpu``)."""
    return torch.cuda.is_available()


def parse_signature(signature):
    """The kernel's C parameter list as ``Param``s: each parameter's
    text, name, base type (qualifiers dropped) and whether it is a
    pointer.  Raises ``TypeError`` on a type the launcher cannot pass."""
    params = []
    for raw in signature.split(","):
        text = " ".join(raw.split())
        tokens = text.replace("*", " * ").split()
        if len(tokens) < 2 or not _IDENT.fullmatch(tokens[-1]):
            raise TypeError(f"cannot parse kernel parameter {raw!r}")
        name, stars = tokens[-1], tokens.count("*")
        base = " ".join(t for t in tokens[:-1]
                        if t != "*" and t not in _QUALIFIERS)
        if stars > 1:
            raise TypeError(f"parameter {name!r}: pointers to pointers "
                            "are not passed by the launcher")
        table = POINTER_TYPES if stars else SCALAR_TYPES
        if base not in table:
            kind = "pointer to" if stars else "scalar"
            raise TypeError(
                f"parameter {name!r}: {kind} type {base!r} is not "
                f"passed by the launcher; it takes {sorted(table)}")
        if any(p.name == name for p in params):
            raise TypeError(f"parameter {name!r} appears twice")
        params.append(Param(text, name, base, bool(stars)))
    return params


def launcher_source(name, params):
    """The C launcher appended to a kernel's source: ``<name>_launch``
    takes the grid, the block, the dynamic shared memory, the stream
    and the kernel's own parameters, launches it and returns
    ``cudaGetLastError()``; ``<name>_error_name`` names an error code."""
    decl = ", ".join(p.text for p in params)
    args = ", ".join(p.name for p in params)
    return f"""
extern "C" int {name}_launch(int gx, int gy, int gz, int bx, int by,
                             int bz, int shared_mem, void* stream,
                             {decl}) {{
  if (shared_mem > 48 * 1024) {{
    cudaError_t e = cudaFuncSetAttribute(
        {name}, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_mem);
    if (e != cudaSuccess) return (int)e;
  }}
  {name}<<<dim3(gx, gy, gz), dim3(bx, by, bz), shared_mem,
          (cudaStream_t)stream>>>({args});
  return (int)cudaGetLastError();
}}

extern "C" const char* {name}_error_name(int e) {{
  return cudaGetErrorName((cudaError_t)e);
}}
"""


def launcher_argtypes(params):
    """The ctypes of ``<name>_launch``, from the same parse that wrote
    its C text: grid, block and shared memory as ``c_int``, the stream
    and every pointer as ``c_void_p``, each scalar as its own type."""
    return [ctypes.c_int] * 7 + [ctypes.c_void_p] + [
        ctypes.c_void_p if p.pointer else SCALAR_TYPES[p.base]
        for p in params]


def _dims(v, what):
    dims = (v,) if isinstance(v, int) else tuple(int(d) for d in v)
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"{what} must have 1 to 3 dimensions, got {v}")
    return dims + (1,) * (3 - len(dims))


class Kernel:
    """A user kernel from :func:`compile_kernel`: call it on tensors as
    ``kernel(*arrays, **scalar_params)``.

    What the parse fixes is resolved once: at construction the
    pointer/scalar partition, each pointer's wanted dtype and each
    scalar's converter, and at the first CUDA launch the built library's
    bound launcher and error function.  A launch then does per call only
    what the call's arrays and params decide (``out_shape``, ``grid``,
    ``block``, ``shared_mem``, ``scalars``, which may be callables, as
    in the reference), its checks, and one ctypes call on the current
    stream."""

    def __init__(self, source, name, signature, out_shape, grid, block,
                 shared_mem, scalars, reference):
        if not _IDENT.fullmatch(name):
            raise ValueError(f"kernel name {name!r} is not a C name")
        self.name = name
        self.params = parse_signature(signature)
        self.source = ("#include <cstdint>\n#include <cuda_runtime.h>\n"
                       + source + "\n" + launcher_source(name, self.params))
        self.argtypes = launcher_argtypes(self.params)
        self._signatures = {
            f"{name}_launch": (self.argtypes, ctypes.c_int),
            f"{name}_error_name": ([ctypes.c_int], ctypes.c_char_p)}
        self.out_shape, self.grid, self.block = out_shape, grid, block
        self.shared_mem, self.scalars = shared_mem, scalars
        self.reference = reference
        self.__name__ = name
        self.__doc__ = reference.__doc__ if reference is not None else None
        pointers = [p for p in self.params if p.pointer]
        self._pointers = [(p.name, p.base, POINTER_TYPES[p.base])
                          for p in pointers]
        self._scalar_names = [p.name for p in self.params if not p.pointer]
        self._scalar_set = frozenset(self._scalar_names)
        # each C parameter in order: (pointer index, None) or (scalar
        # name, its converter)
        index = {p.name: i for i, p in enumerate(pointers)}
        self._order = [
            (index[p.name], None) if p.pointer else
            (p.name, float if p.base in ("float", "double") else int)
            for p in self.params]
        self._launcher = None

    def build(self):
        """Build the kernel now (it is built at first launch anyway);
        returns ``_build.build_source``'s record, with nvcc's report."""
        return _build.build_source(self.source, self.name)

    def _resolve(self, v, arrays, params):
        return v(*arrays, **params) if callable(v) else v

    def __call__(self, *arrays, **params):
        if not arrays or not all(isinstance(a, torch.Tensor)
                                 for a in arrays):
            raise TypeError(f"kernel {self.name} takes torch tensors")
        device = arrays[0].device
        if any(a.device != device for a in arrays):
            raise ValueError(f"kernel {self.name}: arrays on several "
                             "devices")
        if torch.is_grad_enabled() and any(a.requires_grad
                                           for a in arrays):
            raise RuntimeError(
                f"kernel {self.name} has no gradient of its own: "
                "register it with vjp=(fwd, bwd) to differentiate it")
        if device.type == "cuda":
            return self._launch(device, arrays, params)
        if device.type == "meta":
            return self._meta(arrays, params)
        if device.type != "cpu":
            raise ValueError(f"kernel {self.name} runs on cuda or cpu, "
                             f"not {device}")
        if self.reference is None:
            raise MXNetError(
                f"kernel {self.name} got CPU tensors and has no plain "
                "version: pass reference= to compile_kernel")
        return self.reference(*arrays, **params)

    def _meta(self, arrays, params):
        """Shape inference: outputs of ``out_shape`` on ``meta``."""
        spec = self._resolve(self.out_shape, arrays, params)
        specs = (spec,) if isinstance(spec, ShapeDtype) else tuple(spec)
        outs = [torch.empty(tuple(s.shape), dtype=torch_dtype(s.dtype),
                            device="meta") for s in specs]
        return outs[0] if isinstance(spec, ShapeDtype) else tuple(outs)

    def _bind(self):
        """Build and load the library, and keep its launcher and error
        function: the first CUDA launch's one-time work."""
        lib = _build.load_source(self.source, self.name, self._signatures)
        self._launcher = (getattr(lib, f"{self.name}_launch"),
                          getattr(lib, f"{self.name}_error_name"))
        return self._launcher

    def _launch(self, device, arrays, params):
        launch, error_name = self._launcher or self._bind()
        spec = self._resolve(self.out_shape, arrays, params)
        single = isinstance(spec, ShapeDtype)
        specs = (spec,) if single else tuple(spec)
        n_in = len(self._pointers) - len(specs)
        if len(arrays) != n_in:
            raise TypeError(
                f"kernel {self.name} takes {n_in} input arrays "
                f"({[p[0] for p in self._pointers[:n_in]]}), got "
                f"{len(arrays)}")
        outs = [torch.empty(tuple(s.shape), dtype=torch_dtype(s.dtype),
                            device=device) for s in specs]
        tensors = arrays + tuple(outs)
        for (name, base, want), t in zip(self._pointers, tensors):
            if want is not None and t.dtype != want:
                raise TypeError(f"kernel {self.name}: {name} is "
                                f"{base}*, got a {t.dtype} tensor")
            if not t.is_contiguous():
                raise ValueError(f"kernel {self.name}: {name} must be "
                                 "contiguous")
        if not params.keys() <= self._scalar_set:
            unknown = sorted(set(params) - self._scalar_set)
            raise TypeError(f"kernel {self.name} has no parameter "
                            f"{unknown}; its scalars are "
                            f"{self._scalar_names}")
        values = self._resolve(self.scalars, arrays, params)
        values = {**values, **params} if values else params
        try:
            args = [tensors[key].data_ptr() if conv is None
                    else conv(values[key]) for key, conv in self._order]
        except KeyError:
            missing = [n for n in self._scalar_names if n not in values]
            raise TypeError(f"kernel {self.name}: no value for "
                            f"{missing}") from None
        grid = _dims(self._resolve(self.grid, arrays, params), "grid")
        block = _dims(self._resolve(self.block, arrays, params), "block")
        shared = int(self._resolve(self.shared_mem, arrays, params))
        if device.index == torch.cuda.current_device():
            rc = launch(*grid, *block, shared,
                        torch.cuda.current_stream(device).cuda_stream,
                        *args)
        else:
            with torch.cuda.device(device):
                rc = launch(*grid, *block, shared,
                            torch.cuda.current_stream().cuda_stream, *args)
        if rc != 0:
            err = error_name(rc).decode()
            raise MXNetError(f"kernel {self.name}: launch failed: {err}")
        _build.LAUNCHES[self.name] += 1
        return outs[0] if single else tuple(outs)


def compile_kernel(source, name, signature, out_shape, *, grid,
                   block=(256,), shared_mem=0, scalars=None,
                   reference=None):
    """Wrap the CUDA ``__global__`` kernel ``name`` of ``source`` into a
    callable on torch tensors.

    Parameters
    ----------
    source : CUDA C++ text defining ``__global__ void name(...)``.
    signature : the kernel's C parameter list, e.g. ``"const float* x,
        float* o, float alpha, long long n"``.  Pointers bind, in
        order, to the input tensors and then to the outputs; scalars
        (``float``, ``double``, ``int``, ``long long``, ``int64_t``)
        bind by name to the call's keyword params, then to ``scalars``.
    out_shape : a ``ShapeDtype`` or a list of them, one per output,
        which the wrapper allocates with ``torch.empty``.
    grid, block : 1 to 3 dimensions.
    shared_mem : bytes of dynamic shared memory.
    scalars : dict of scalar values that come from shapes rather than
        from the caller (``{"n": x.numel()}``).
    reference : the plain PyTorch version ``reference(*arrays,
        **params)``, run for CPU tensors; without it a CPU call raises.

    ``out_shape``, ``grid``, ``block``, ``shared_mem`` and ``scalars``
    may each be a callable ``(*arrays, **params)``, evaluated per call.
    For CUDA tensors the kernel launches or raises: a missing ``nvcc``,
    a failed build or a refused launch is an error.  Each launch adds
    one to ``ops.LAUNCHES[name]``.
    """
    return Kernel(source, name, signature, out_shape, grid, block,
                  shared_mem, scalars, reference)


class _CustomVJP(torch.autograd.Function):
    """An op with a user VJP in the ``jax.custom_vjp`` convention:
    ``fwd(*arrays, **params) -> (out, residuals)`` and ``bwd(*param
    values in sorted-name order, residuals, g) -> grads``.  Tensors
    among the residuals travel through ``ctx.save_for_backward``."""

    @staticmethod
    def forward(ctx, fwd, bwd, full, *arrays):
        out, res = fwd(*arrays, **full)
        kind = type(res) if isinstance(res, (tuple, list)) else None
        flat = list(res) if kind else [res]
        is_tensor = [isinstance(r, torch.Tensor) for r in flat]
        ctx.save_for_backward(*[r for r, t in zip(flat, is_tensor) if t])
        ctx.rest = [None if t else r for r, t in zip(flat, is_tensor)]
        ctx.is_tensor, ctx.kind, ctx.bwd = is_tensor, kind, bwd
        ctx.values = tuple(full[k] for k in sorted(full))
        return out

    @staticmethod
    def backward(ctx, *gs):
        saved = iter(ctx.saved_tensors)
        flat = [next(saved) if t else r
                for t, r in zip(ctx.is_tensor, ctx.rest)]
        res = ctx.kind(flat) if ctx.kind else flat[0]
        g = gs[0] if len(gs) == 1 else gs
        return (None, None, None) + tuple(ctx.bwd(*ctx.values, res, g))


def register(name, fn, *, vjp=None, arg_names=None,
             differentiable=None, num_outputs=1, aliases=(),
             **opdef_kwargs):
    """Register ``fn`` as operator ``name`` on ``nd`` and ``sym``.

    Parameters
    ----------
    fn : ``(*torch tensors, **static_params) -> tensor(s)``, typically
        a :func:`compile_kernel` kernel.
    vjp : optional ``(fwd, bwd)`` pair giving the op a custom gradient
        (``jax.custom_vjp`` convention): ``fwd(*arrays, **params) ->
        (out, residuals)`` and ``bwd(*param_values, residuals,
        cotangent) -> grads``, where param_values are the op's params
        in sorted-name order, with ``fwd``'s defaults filled in.
        Without one, the op differentiates through torch autograd if it
        can (plain PyTorch functions can; a kernel raises).
    arg_names : tensor input names (default: fn's positional
        signature).
    aliases : extra registry names.

    Returns the ``nd`` function.
    """
    if name in OPS:
        raise ValueError(
            f"op '{name}' already exists; rtc.register cannot "
            "shadow a built-in or an earlier custom kernel")
    clashes = [a for a in aliases if a in OPS]
    if clashes:            # validate before changing the registry
        raise ValueError(f"aliases {clashes} conflict with existing ops")
    if vjp is not None:
        vjp_fwd, vjp_bwd = vjp
        base = fn
        # the bwd rule sees the same param values whether the caller
        # passed them or relied on fwd's defaults
        try:
            fwd_defaults = {
                p.name: p.default
                for p in inspect.signature(vjp_fwd).parameters.values()
                if p.default is not p.empty}
        except (TypeError, ValueError):
            fwd_defaults = {}

        @functools.wraps(base, updated=())
        def fn(*arrays, **params):  # noqa: F811 — deliberate rewrap
            full = {**fwd_defaults, **params}
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in arrays):
                return _CustomVJP.apply(vjp_fwd, vjp_bwd, full, *arrays)
            return base(*arrays, **full)

    if differentiable is None:
        differentiable = True
    if arg_names is None:
        try:
            sig = inspect.signature(fn)
            arg_names = [p.name for p in sig.parameters.values()
                         if p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)
                         and p.default is p.empty
                         and not p.name.startswith("_")]
        except (TypeError, ValueError):
            arg_names = []
        if not arg_names:
            # a compile_kernel kernel takes *arrays: without arg_names
            # a multi-input kernel would register as one-input
            warnings.warn(
                f"rtc.register({name!r}): cannot infer arg_names "
                "from the function signature (it takes *arrays); "
                "defaulting to ['data'] (single input).  Pass "
                "arg_names=[...] explicitly for multi-input kernels.",
                stacklevel=2)
            arg_names = ["data"]
    op = OpDef(name, fn, num_outputs=num_outputs, arg_names=arg_names,
               differentiable=differentiable, **opdef_kwargs)
    OPS[name] = op
    ndf = _attach(name, op)
    for a in aliases:
        OPS[a] = op
        _attach(a, op)
    _RTC_ALIASES[name] = tuple(aliases)
    return ndf


def _targets(name):
    """The ``nd`` and ``sym`` namespaces an op named ``name`` lands
    on."""
    from . import ndarray as nd_mod
    from . import symbol as sym_mod
    return [mod._internal if name.startswith("_") else mod
            for mod in (nd_mod, sym_mod)]


def _attach(name, op):
    """Bind the new op onto the already-populated ``nd`` and ``sym``
    namespaces; returns the ``nd`` function."""
    from .ndarray.register import make_nd_func
    from .symbol.register import make_sym_func
    ndf = make_nd_func(name, op)
    nd_target, sym_target = _targets(name)
    setattr(nd_target, name, ndf)
    setattr(sym_target, name, make_sym_func(name, op))
    return ndf


_RTC_ALIASES = {}    # primary name -> aliases, for unregister


def unregister(name):
    """Remove a custom op registered by :func:`register`, with its
    aliases, from the registry, ``nd`` and ``sym``."""
    for n in (name,) + _RTC_ALIASES.pop(name, ()):
        OPS.pop(n, None)
        for target in _targets(n):
            if hasattr(target, n):
                delattr(target, n)

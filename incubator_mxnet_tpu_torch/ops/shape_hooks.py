"""Per-op argument-shape inference hooks.

Role analog of the reference's FInferShape attrs (ref:
src/executor/infer_graph_attr_pass.cc fixed-point inference): given
the *known* input shapes of a node, fill in the shapes of its
parameter/aux inputs so `simple_bind(data=(N, ...))` can allocate
every weight without the user spelling them out.

Output shapes need no hooks: once every input is known, running the
op gives them.
"""
from .registry import OPS


def _prod(t):
    out = 1
    for v in t:
        out *= v
    return out


def _tup(v, n, default):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t + (default,) * (n - len(t))


HOOKS = {}


def hook(name):
    def _reg(fn):
        HOOKS[name] = fn
        for alias_name, op in OPS.items():
            if op is OPS.get(name) and alias_name != name:
                HOOKS[alias_name] = fn
        return fn
    return _reg


@hook("FullyConnected")
def _fc(shapes, params):
    data = shapes[0]
    if data is None:
        return shapes
    nh = int(params.get("num_hidden", 0))
    ind = _prod(data[1:]) if params.get("flatten", True) else data[-1]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nh, ind)
    if len(out) > 2 and out[2] is None:
        out[2] = (nh,)
    return out


@hook("Convolution")
def _conv(shapes, params):
    data = shapes[0]
    if data is None:
        return shapes
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    k = tuple(int(x) for x in params.get("kernel", ()))
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nf, data[1] // ng) + k
    if len(out) > 2 and out[2] is None:
        out[2] = (nf,)
    return out


@hook("Deconvolution")
def _deconv(shapes, params):
    data = shapes[0]
    if data is None:
        return shapes
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    k = tuple(int(x) for x in params.get("kernel", ()))
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (data[1], nf // ng) + k
    if len(out) > 2 and out[2] is None:
        out[2] = (nf,)
    return out


def _channel_params(n_param):
    def _h(shapes, params):
        data = shapes[0]
        if data is None:
            return shapes
        ax = int(params.get("axis", 1)) % len(data)
        c = data[ax]
        out = list(shapes)
        for i in range(1, min(len(out), 1 + n_param)):
            if out[i] is None:
                out[i] = (c,)
        return out
    return _h


HOOKS["BatchNorm"] = _channel_params(4)
HOOKS["BatchNorm_v1"] = _channel_params(4)
HOOKS["CuDNNBatchNorm"] = _channel_params(4)
HOOKS["InstanceNorm"] = _channel_params(2)


def _layernorm(shapes, params):
    data = shapes[0]
    if data is None:
        return shapes
    ax = int(params.get("axis", -1)) % len(data)
    c = data[ax]
    out = list(shapes)
    for i in (1, 2):
        if i < len(out) and out[i] is None:
            out[i] = (c,)
    return out


HOOKS["LayerNorm"] = _layernorm


@hook("Embedding")
def _embed(shapes, params):
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (int(params.get("input_dim", 0)),
                  int(params.get("output_dim", 0)))
    return out


def _prelu(shapes, params):
    if params.get("act_type") != "prelu" or shapes[0] is None:
        return shapes
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (shapes[0][1],)
    return out


HOOKS["LeakyReLU"] = _prelu

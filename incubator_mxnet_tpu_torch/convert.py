"""Carry weights from the JAX package's models into the port's.

``load_gluon_params(block, arrays)`` fills a Gluon block (ResNet, any
``gluon.Block``) from ``{name: array}``, e.g. the JAX net's
``{k: p.data().asnumpy() for k, p in net.collect_params().items()}``,
BatchNorm's running stats included.  Names match after each net's own
prefix is stripped, so two nets built in one process (``resnetv10_``,
``resnetv11_``) still match.  The ``.params`` file
(``save_parameters`` / ``load_parameters``) is the other way across.

For the TransformerLM:
``wts`` is the nested dict of numpy arrays that the JAX model's
``_decode_weights()`` returns (the tests take it with
``jax.tree_util.tree_map(np.asarray, net._decode_weights())``):
``embed``, ``pos``, ``layers[i].{ln1,qkv,proj,ln2}`` with
``{up,down}`` or, for an MoE layer, ``moe`` (router weight, stacked
expert up weight and bias, down weight and bias), ``ln_f``, ``head``.
Both packages keep the same layouts (Dense weights are (out, in)), so
each array is copied as it is.  This module imports
neither JAX nor the JAX package: it reads plain arrays.

For the recurrent stack: a Gluon ``.params`` file of ``rnn.LSTM`` /
``GRU`` / ``RNN`` loads with ``load_parameters`` (the per-layer names
``l0_i2h_weight`` ... are the same), and so does the dict through
``load_gluon_params``.  ``load_module_checkpoint(module, prefix,
epoch)`` loads a ``Module`` or ``BucketingModule`` checkpoint of either
package, ``rnn_parameters`` included, into a bound port module, after
checking every fused ``RNN`` node's flat vector against the length its
mode, layers, widths and directions need.  ``unpack_rnn_parameters``
cuts such a flat vector into the Gluon layer's names, and
``load_rnn_parameters(layer, flat)`` fills a Gluon fused layer from it,
so a symbolic model's weights carry over to the Gluon one.

Arrays of the ``nd`` surface need no function here: they cross between
the packages as numpy arrays (``nd.array(x.asnumpy(), ctx=...)``),
through DLPack (``nd.from_dlpack``), or as files, since ``nd.save`` and
``nd.load`` keep the JAX package's npz format.
"""
import numpy as np
import torch

from .context import as_device

__all__ = ["load_reference_weights", "load_gluon_params",
           "load_module_checkpoint", "unpack_rnn_parameters",
           "load_rnn_parameters"]


def _src_prefix(names):
    """The source net's own prefix: the first name's text up to its
    first "_" (a top-level block's prefix is ``<alias><count>_``), if
    every name starts with it; else none."""
    names = list(names)
    head = names[0].split("_", 1)[0] + "_" if names else ""
    if "_" in names[0] and all(n.startswith(head) for n in names):
        return head
    return ""


def load_gluon_params(block, arrays, ctx=None):
    """Copy ``arrays`` ({name: array-like}) into ``block``'s parameters;
    returns the block.  A name is matched after stripping the source
    net's prefix from it (``_src_prefix``) and ``block.prefix`` from the
    block's own.  A parameter without storage is made on ``ctx`` (None:
    the card); one with storage keeps its device unless ``ctx`` is
    given.  Raises ``ValueError`` on a name the block has and ``arrays``
    lacks, or a shape mismatch."""
    src_prefix = _src_prefix(arrays)
    src = {k[len(src_prefix):]: v for k, v in arrays.items()}
    own = block.collect_params()
    keys = {name: name[len(block.prefix):]
            if name.startswith(block.prefix) else name for name in own}
    missing = [name for name, key in keys.items() if key not in src]
    if missing:
        raise ValueError(f"arrays lack {len(missing)} parameters of the "
                         f"block: {missing[:5]}")
    for name, p in own.items():
        arr = torch.from_numpy(np.array(src[keys[name]], copy=True))
        shape = p.shape
        if shape is not None and all(shape) \
                and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the "
                             f"block has {tuple(shape)}")
        device = as_device(ctx) if ctx is not None else p._target(None)
        if p._allocated() and p._var.device != device:
            p.reset_ctx(device)
        p.set_data(arr.to(device=device, dtype=p._tdtype))
    return block


def load_reference_weights(model, wts):
    """Copy ``wts`` into ``model``'s parameters; returns the model.
    Raises ``ValueError`` on a missing key or a shape mismatch (a dense
    layer against an MoE one among them), and ``NotImplementedError`` on
    int8 ``{q, s}`` leaves, which the port does not carry."""
    with torch.no_grad():
        _copy(model._decode_params(), wts, "wts")
    return model


def _copy(dst, src, path):
    if isinstance(dst, dict):
        if not isinstance(src, dict):
            raise ValueError(f"{path}: expected a dict, got "
                             f"{type(src).__name__}")
        missing = sorted(set(dst) - set(src))
        if missing:
            raise ValueError(f"{path}: missing {missing}")
        for key, sub in dst.items():
            _copy(sub, src[key], f"{path}[{key!r}]")
    elif isinstance(dst, (list, tuple)):
        if len(src) != len(dst):
            raise ValueError(f"{path}: {len(src)} entries, the model "
                             f"has {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy(d, s, f"{path}[{i}]")
    else:
        if isinstance(src, dict):
            raise NotImplementedError(
                f"{path}: int8 {{q, s}} weights are not ported yet")
        arr = np.array(src, dtype=np.float32)
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{path}: shape {arr.shape}, the model has "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))


def unpack_rnn_parameters(flat, mode, num_layers, input_size, state_size,
                          bidirectional=False):
    """The fused ``RNN`` op's flat vector (MXNet's packing: all weights
    layer-major, then all biases) as ``{name: numpy array}`` under the
    Gluon layer's names (``l0_i2h_weight`` ... ``r{i}_h2h_bias``)."""
    from .ops.rnn import _unpack_params, rnn_param_size
    flat = torch.as_tensor(np.asarray(flat, dtype=np.float32)).reshape(-1)
    n = rnn_param_size(mode, num_layers, input_size, state_size,
                       bidirectional)
    if flat.numel() != n:
        raise ValueError(f"rnn parameters: {flat.numel()} values, {mode} "
                         f"with {num_layers} layers, input {input_size}, "
                         f"state {state_size}, bidirectional="
                         f"{bidirectional} needs {n}")
    weights, biases = _unpack_params(flat, mode, num_layers, input_size,
                                     state_size, bidirectional)
    dirs = ["l", "r"][:2 if bidirectional else 1]
    out = {}
    for k, ((w_ih, w_hh), (b_ih, b_hh)) in enumerate(zip(weights, biases)):
        tag = f"{dirs[k % len(dirs)]}{k // len(dirs)}"
        for name, t in (("i2h_weight", w_ih), ("h2h_weight", w_hh),
                        ("i2h_bias", b_ih), ("h2h_bias", b_hh)):
            out[f"{tag}_{name}"] = t.numpy().copy()
    return out


def load_rnn_parameters(layer, flat, ctx=None):
    """Fill a Gluon fused layer (``rnn.LSTM`` / ``GRU`` / ``RNN``) from a
    fused ``RNN`` op's flat vector (a Module's ``rnn_parameters``);
    returns the layer.  The first layer's input width comes from the
    layer, or from the vector's length when it is still deferred."""
    from .ops.rnn import _GATES
    G, H, L = _GATES[layer._mode], layer._hidden_size, layer._num_layers
    D = layer._dir
    n = int(np.asarray(flat).size)
    input_size = layer._input_size
    if not input_size:
        rest = sum(D * (G * H * H * D + G * H * H + 2 * G * H)
                   for _ in range(L - 1))
        input_size = (n - rest) // D // (G * H) - H - 2
    arrays = unpack_rnn_parameters(flat, layer._mode, L, input_size, H,
                                   D == 2)
    return load_gluon_params(layer, {layer.prefix + k: v
                                     for k, v in arrays.items()}, ctx=ctx)


def _check_rnn_nodes(symbol, arg_params, shapes):
    """Every fused RNN node's flat vector has the length its mode,
    layers, widths and directions need."""
    from .ops.rnn import rnn_param_size
    from .symbol.symbol import _topo
    internals = symbol.get_internals()
    # inputs only: a wrong-length flat vector must not stop inference
    _, out_shapes, _ = internals.infer_shape_partial(
        **{k: v for k, v in shapes.items() if k not in arg_params})
    inferred = {(id(node), i): shape
                for (node, i), shape in zip(internals._heads, out_shapes)}
    for node in _topo(symbol._heads):
        if node.op is None or node.op.name != "RNN":
            continue
        pnode, _ = node.inputs[1]
        data = inferred.get((id(node.inputs[0][0]), node.inputs[0][1]))
        if not pnode.is_variable or pnode.name not in arg_params \
                or data is None:
            continue
        p = node.params
        need = rnn_param_size(p.get("mode", "lstm"),
                              int(p.get("num_layers", 1)), data[-1],
                              int(p.get("state_size", 0)),
                              bool(p.get("bidirectional", False)))
        got = int(np.prod(arg_params[pnode.name].shape))
        if got != need:
            raise ValueError(f"{pnode.name}: {got} values, the RNN node "
                             f"'{node.name}' needs {need}")


def load_module_checkpoint(module, prefix, epoch, ctx=None):
    """Load ``prefix-%04d.params`` (a ``Module`` or ``BucketingModule``
    checkpoint of either package) into the bound ``module``; returns the
    checkpoint's symbol.  Each fused RNN node's ``rnn_parameters`` is
    checked against the length the node needs before anything loads."""
    from .context import cpu
    from .model import load_checkpoint
    symbol, arg, aux = load_checkpoint(prefix, epoch,
                                       ctx=ctx if ctx is not None else cpu())
    shapes = {d.name: d.shape for d in list(module.data_shapes)
              + list(module.label_shapes or [])}
    _check_rnn_nodes(module.symbol, arg, shapes)
    module.set_params(arg, aux)
    return symbol

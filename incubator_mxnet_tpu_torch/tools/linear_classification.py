#!/usr/bin/env python3
"""Config 5, the sparse linear classifier, on the port.

    python3 -m incubator_mxnet_tpu_torch.tools.linear_classification \\
        [--quick] [--cpu] [--num-epochs N] [--batch-size N] [--dim N]

The loop of ``examples/linear_classification.py`` (:109-140; ref:
MXNet 0.12's example/sparse/linear_classification.py): LibSVM text read
as CSR batches by ``io.LibSVMIter``, the (dim, 1) weight kept in a
KVStore whose updater is the lazy ``sparse.sgd_update``, each batch
pulling only the rows its features touch (``row_sparse_pull`` into a
row-sparse array), ``sparse.dot`` for the logits and ``sparse.dot`` of
the CSR's transpose, row-sparse, for the gradient.  The data and the
evaluation are the example's own ``make_libsvm`` and ``evaluate``, which
take the package as an argument; so does ``run_loop``, which the tests
run on both packages.  Without ``--cpu`` the arrays live on the first
CUDA card (the batches cross to it once); ``--quick`` applies the
example's gate: final NLL below 0.65 of the first, validation accuracy
above 0.8, fewer rows pulled than 0.75 of a dense pull.  ``final_nll``
is the example's; ``final_nll_f64`` the same with float64 logits, finite
where the example's float32 one is not (``evaluate_f64``).
"""
import argparse
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

EXAMPLE = Path(__file__).resolve().parents[2] / "examples" \
    / "linear_classification.py"


def example():
    """``examples/linear_classification.py`` as a module (its package
    imports are inside its ``main``)."""
    spec = importlib.util.spec_from_file_location("_linear_cls_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sizes(quick=False, dim=None, num_epochs=None, batch_size=None):
    """The example's sizes: (dim, training rows, epochs, batch size,
    density)."""
    return (dim or (400 if quick else 2000), 1024 if quick else 8192,
            num_epochs or (15 if quick else 30),
            batch_size or (32 if quick else 64),
            0.025 if quick else 0.02)


def make_batches(mx, dim, n_train, batch_size, density, ex=None):
    """The example's data (seed 3): its true weight, then the training
    and validation files through ``make_libsvm``, read back through
    ``mx.io.LibSVMIter``; returns (train batches, val batches)."""
    ex = ex or example()
    rs = np.random.RandomState(3)
    true_w = (rs.randn(dim) * 2).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        tr_path = os.path.join(td, "train.libsvm")
        va_path = os.path.join(td, "val.libsvm")
        ex.make_libsvm(tr_path, n_train, dim, density, rs, true_w)
        ex.make_libsvm(va_path, max(256, n_train // 8), dim, density, rs,
                       true_w)
        train = list(mx.io.LibSVMIter(data_libsvm=tr_path,
                                      data_shape=(dim,),
                                      batch_size=batch_size))
        val = list(mx.io.LibSVMIter(data_libsvm=va_path,
                                    data_shape=(dim,),
                                    batch_size=batch_size))
    return train, val


def evaluate_f64(batches, kv, dim, bias, mx):
    """The example's ``evaluate`` with the logits in float64.  At the
    default size the weights grow until a float32 sigmoid rounds to 1,
    where the example's clip leaves it (1 - 1e-8 is 1 in float32), so
    its NLL takes log(0) and is nan in either package; its accuracy is
    unaffected.  This NLL stays finite."""
    weight = mx.nd.zeros((dim, 1))
    kv.pull("weight", out=weight)
    nll = correct = total = 0.0
    for b in batches:
        x, y = b.data[0], b.label[0].asnumpy().ravel().astype(np.float64)
        logits = mx.nd.sparse.dot(x, weight).asnumpy()[:, 0] \
            .astype(np.float64) + bias
        p = np.clip(1.0 / (1.0 + np.exp(-logits)), 1e-8, 1 - 1e-8)
        nll += float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).sum())
        correct += float(((p > 0.5) == (y > 0.5)).sum())
        total += len(y)
    return nll / total, correct / total


def run_loop(mx, train_batches, val_batches, dim, epochs, lr=3.0,
             kv_store="local", ex=None):
    """The example's training loop (:109-140) on package ``mx``; arrays
    made without a ``ctx`` go to its current context.  Returns its
    numbers and the final weight (numpy)."""
    ex = ex or example()
    nd = mx.nd
    sparse = mx.nd.sparse
    kv = mx.kv.create(kv_store)
    kv.init("weight", nd.zeros((dim, 1)))
    kv.set_updater(lambda key, grad, stored: sparse.sgd_update(
        stored, grad, lr=lr))
    w_rsp = sparse.row_sparse_array(np.zeros((1, 1), np.float32),
                                    shape=(dim, 1))
    bias = 0.0
    first_nll, _ = ex.evaluate(val_batches, kv, dim, bias, mx, nd, sparse)
    steps = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        pulled_rows = 0
        for b in train_batches:
            x, y = b.data[0], b.label[0].asnumpy().ravel()
            kv.row_sparse_pull("weight", out=w_rsp, row_ids=x.indices)
            pulled_rows += int(w_rsp.indices.shape[0])
            logits = sparse.dot(x, w_rsp).asnumpy()[:, 0] + bias
            p = 1.0 / (1.0 + np.exp(-logits))
            gl = nd.array(((p - y) / len(y))[:, None].astype(np.float32))
            gw = sparse.dot(x, gl, transpose_a=True,
                            forward_stype="row_sparse")
            kv.push("weight", gw)
            bias -= lr * float((p - y).mean())
            steps += 1
    seconds = time.perf_counter() - t0
    final_nll, final_acc = ex.evaluate(val_batches, kv, dim, bias, mx, nd,
                                       sparse)
    final_nll_f64, _ = evaluate_f64(val_batches, kv, dim, bias, mx)
    weight = nd.zeros((dim, 1))
    kv.pull("weight", out=weight)
    return {"first_nll": first_nll, "final_nll": final_nll,
            "final_nll_f64": final_nll_f64, "val_acc": final_acc,
            "rows_pulled_per_epoch": pulled_rows,
            "dense_rows_equiv_per_epoch": len(train_batches) * dim,
            "steps": steps, "train_seconds": seconds, "bias": bias,
            "weight": weight.asnumpy()}


def gate(out):
    """The example's ``--quick`` gate (:149-155); raises if it fails."""
    assert out["final_nll"] < 0.65 * out["first_nll"], \
        (out["first_nll"], out["final_nll"])
    assert out["val_acc"] > 0.8, out["val_acc"]
    assert out["rows_pulled_per_epoch"] < \
        0.75 * out["dense_rows_equiv_per_epoch"], \
        (out["rows_pulled_per_epoch"], out["dense_rows_equiv_per_epoch"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3.0)
    ap.add_argument("--kv-store", default="local")
    args = ap.parse_args(argv)

    import incubator_mxnet_tpu_torch as mt
    ctx = mt.cpu() if args.cpu else mt.gpu(0)
    if not args.cpu:
        mt.context.default_device()            # raises without a card
    dim, n_train, epochs, batch_size, density = sizes(
        args.quick, args.dim, args.num_epochs, args.batch_size)
    t0 = time.time()
    ex = example()
    train, val = make_batches(mt, dim, n_train, batch_size, density, ex)
    with ctx:
        out = run_loop(mt, train, val, dim, epochs, args.lr, args.kv_store,
                       ex)
    out.pop("weight")
    out.update(example="linear_classification", dim=dim, epochs=epochs,
               device=str(ctx), seconds=round(time.time() - t0, 1))
    print(json.dumps(out))
    if args.quick:
        gate(out)
    return out


if __name__ == "__main__":
    main()

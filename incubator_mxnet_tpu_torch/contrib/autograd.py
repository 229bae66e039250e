"""Legacy experimental autograd namespace (twin of
``incubator_mxnet_tpu/contrib/autograd.py``; ref:
python/mxnet/contrib/autograd.py — the pre-1.0 experimental API the
reference kept alongside ``mx.autograd``).

Everything here is the core tape under the old names:
``train_section``/``test_section`` context managers and
``compute_gradient``; new code should use ``mx.autograd``.
"""
from ..autograd import (record as train_section,          # noqa: F401
                        pause as test_section,
                        backward,
                        mark_variables,
                        grad)

__all__ = ["train_section", "test_section", "backward",
           "mark_variables", "grad_and_loss", "grad",
           "compute_gradient"]


def compute_gradient(outputs):
    """Legacy spelling of ``backward(outputs)``."""
    return backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorator: ``f(*args) -> (grads, outputs)`` (the legacy
    experimental API's shape — ref contrib/autograd.py
    grad_and_loss)."""
    import functools

    from .. import nd as _nd
    from ..autograd import record as _record

    def _as_list(x):
        return list(x) if isinstance(x, (list, tuple)) else [x]

    @functools.wraps(func)
    def wrapped(*args):
        sel = _as_list(argnum) if argnum is not None \
            else list(range(len(args)))
        variables = [args[i] for i in sel]
        for v in variables:
            v.attach_grad()
        with _record():
            outputs = func(*args)
            head = outputs[0] if isinstance(
                outputs, (list, tuple)) else outputs
            total = _nd.sum(head) if head.ndim else head
        total.backward()
        grads = [v.grad for v in variables]
        return grads, outputs
    return wrapped

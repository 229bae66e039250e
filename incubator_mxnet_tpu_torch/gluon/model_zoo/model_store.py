"""Pretrained-weight store (twin of
``incubator_mxnet_tpu/gluon/model_zoo/model_store.py``; ref role:
python/mxnet/gluon/model_zoo/model_store.py get_model_file/purge).

The store is local and fetches nothing: weights are installed into it
(``import_model_file``, or a ``<name>.params`` file saved there), and
``pretrained=True`` resolves from it.  The layout is the JAX package's,
so either package reads the other's store: the root is
``$MXTPU_HOME/models`` (default ``~/.mxtpu/models``), overridable per
call with ``root=``; a file is ``<name>.params`` or the reference's
sha1-tagged ``<name>-xxxxxxxx.params``, whose digest is checked.
"""
import hashlib
import os
import shutil

__all__ = ["get_model_file", "import_model_file", "purge", "list_models",
           "load_pretrained"]


def _default_root():
    home = os.environ.get("MXTPU_HOME",
                          os.path.join(os.path.expanduser("~"), ".mxtpu"))
    return os.path.join(home, "models")


def _root(root):
    return os.path.expanduser(root or _default_root())


def _file_name(name, sha1=None):
    return f"{name}-{sha1[:8]}.params" if sha1 else f"{name}.params"


def get_model_file(name, root=None):
    """Path of the stored params file of ``name``: ``<name>.params``, else
    the newest sha1-tagged ``<name>-xxxxxxxx.params``, whose digest must
    match its tag.  Raises FileNotFoundError if neither is there."""
    root = _root(root)
    plain = os.path.join(root, _file_name(name))
    if os.path.exists(plain):
        return plain
    if os.path.isdir(root):
        tagged = sorted(
            (f for f in os.listdir(root)
             if f.startswith(name + "-") and f.endswith(".params")
             and len(f) == len(name) + 1 + 8 + len(".params")),
            key=lambda f: os.path.getmtime(os.path.join(root, f)))
        if tagged:
            path = os.path.join(root, tagged[-1])
            tag = tagged[-1][len(name) + 1:-len(".params")]
            if not _sha1(path).startswith(tag):
                raise OSError(
                    f"checksum mismatch for {path}; re-install it "
                    f"(import_model_file) or delete it (purge)")
            return path
    raise FileNotFoundError(
        f"no pretrained weights for '{name}' in {root}: the store fetches "
        f"nothing; install a params file with "
        f"model_store.import_model_file(src, '{name}') or save one to "
        f"{plain}")


def import_model_file(src, name, root=None):
    """Copy a params file into the store under ``name`` with the
    reference's sha1-tagged file name; returns the stored path."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, _file_name(name, _sha1(src)))
    shutil.copyfile(src, dst)
    return dst


def list_models(root=None):
    """The names with weights in the store."""
    root = _root(root)
    if not os.path.isdir(root):
        return []
    names = set()
    for f in os.listdir(root):
        if f.endswith(".params"):
            stem = f[:-len(".params")]
            base, dash, tag = stem.rpartition("-")
            names.add(base if dash and len(tag) == 8 else stem)
    return sorted(names)


def purge(root=None):
    """Delete every stored params file (ref: model_store.purge)."""
    root = _root(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))


def load_pretrained(net, name, ctx=None, root=None):
    """Resolve ``name`` in the store and load it into ``net`` on ``ctx``
    (the factories' half of ``pretrained=True``)."""
    net.load_params(get_model_file(name, root=root), ctx=ctx)
    return net


def _sha1(path):
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()

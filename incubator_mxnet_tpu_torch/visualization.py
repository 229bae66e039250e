"""Network visualization (twin of ``incubator_mxnet_tpu/visualization.py``;
ref: python/mxnet/visualization.py — print_summary:355, plot_network).

print_summary walks the Symbol graph exactly like the reference
(topological order, per-layer shape + parameter count columns);
plot_network returns a graphviz ``Digraph`` when the library is
installed, and otherwise a ``Dot`` with the same nodes and edges, whose
``source`` is the graph in the DOT language.
"""

__all__ = ["print_summary", "plot_network", "Dot"]


class Dot:
    """The graph description ``plot_network`` builds, without graphviz:
    ``node``/``edge`` as graphviz's ``Digraph`` takes them, ``source``
    the DOT text (``graphviz.Source(dot.source)`` renders it)."""

    def __init__(self, name="plot", format="pdf"):
        self.name = name
        self.format = format
        self.nodes = []     # (name, label, attrs)
        self.edges = []     # (tail, head)

    def node(self, name, label=None, **attrs):
        self.nodes.append((name, label if label is not None else name,
                           attrs))

    def edge(self, tail_name, head_name, **attrs):
        self.edges.append((tail_name, head_name))

    @property
    def source(self):
        def q(text):
            return '"' + str(text).replace('"', '\\"') \
                .replace("\n", "\\n") + '"'
        lines = [f"digraph {q(self.name)} {{"]
        for name, label, attrs in self.nodes:
            extra = "".join(f" {k}={q(v)}" for k, v in attrs.items())
            lines.append(f"\t{q(name)} [label={q(label)}{extra}]")
        for tail, head in self.edges:
            lines.append(f"\t{q(tail)} -> {q(head)}")
        lines.append("}")
        return "\n".join(lines) + "\n"


def print_summary(symbol, shape=None, line_length=120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer-table summary of a Symbol (ref:
    visualization.py print_summary)."""
    if shape is not None:
        arg_shapes, out_shapes, aux_shapes = \
            symbol.infer_shape_partial(**shape)
        shape_dict = dict(zip(symbol.list_arguments(), arg_shapes))
    else:
        shape_dict = {}
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #",
              "Previous Layer"]

    def print_row(values, positions):
        line = ""
        for i, v in enumerate(values):
            line += str(v)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0

    internals = symbol.get_internals()
    seen_params = set()
    rows = []
    for out in internals:
        node = out._heads[0][0] if hasattr(out, "_heads") else None
        if node is None or node.is_variable:
            continue
        name = node.name
        op_name = node.op.name if hasattr(node.op, "name") else \
            str(node.op)
        prevs = [inp[0].name for inp in node.inputs
                 if not inp[0].is_variable]
        n_params = 0
        for inp, _ in node.inputs:
            if inp.is_variable and inp.name in shape_dict and \
                    inp.name not in seen_params and \
                    not inp.name.endswith(("data", "label")):
                cnt = 1
                for d in shape_dict[inp.name]:
                    cnt *= d
                n_params += cnt
                seen_params.add(inp.name)
        total_params += n_params
        out_shape = ""
        if shape is not None:
            try:
                _, os_, _ = out.infer_shape_partial(**shape)
                out_shape = str(os_[0]) if os_ else ""
            except Exception:
                out_shape = "?"
        rows.append(([f"{name} ({op_name})", out_shape, n_params,
                      ",".join(prevs)]))
    for i, row in enumerate(rows):
        print_row(row, positions)
        print(("=" if i == len(rows) - 1 else "_") * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", shape=None,
                 node_attrs=None, save_format="pdf"):
    """Graphviz plot of the Symbol graph (ref: visualization.py
    plot_network): a graphviz ``Digraph`` when graphviz is installed,
    else a :class:`Dot` of the same nodes and edges."""
    try:
        from graphviz import Digraph
    except ImportError:
        Digraph = Dot
    dot = Digraph(name=title, format=save_format)
    internals = symbol.get_internals()
    for out in internals:
        node = out._heads[0][0] if hasattr(out, "_heads") else None
        if node is None:
            continue
        if node.is_variable:
            dot.node(node.name, node.name, shape="oval")
        else:
            op_name = node.op.name if hasattr(node.op, "name") \
                else str(node.op)
            dot.node(node.name, f"{node.name}\n{op_name}",
                     shape="box")
            for inp, _ in node.inputs:
                dot.edge(inp.name, node.name)
    return dot

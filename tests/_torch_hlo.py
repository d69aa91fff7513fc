"""Counts read from a compiled XLA module's text (``compiled.as_text()``),
for the reference's dry-run records (``tests/_torch_launch_ref.py``) and
the tests that check them. Plain Python: no JAX.

* :func:`dot_flops`: 2·M·N·K of every ``dot``, the matmul part of
  ``cost_analysis()["flops"]`` (which also counts elementwise ops); with
  ``conv=True`` also :func:`conv_flops` and the products of every dot XLA
  rewrote into a ``multiply``, the products of the whole module.
* :func:`conv_flops`: 2 × output elements × window size × input features
  ÷ ``feature_group_count`` of every ``convolution``.
* :func:`hlo_bytes`: ``cost_analysis()["bytes accessed"]`` recounted
  instruction by instruction with the rules of XLA's ``HloCostAnalysis``
  (an op reads its operands and writes its output; a fusion reads each
  parameter once, a slice of it where only slices read it, and writes its
  output, or the update of an in-place dynamic-update-slice; a while loop
  counts its body once; parameters, constants, tuples, bitcasts move
  nothing). With ``layout=False`` it leaves out what XLA's module moves
  that an eager step does not run: its layout ops.
"""
import math
import re

_ITEM = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
         "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
         "f64": 8}
_HEAD = re.compile(r"^(ENTRY )?%([\w.\-]+) \(.*\) -> .* \{$")
_INSTR = re.compile(r"^\s*(ROOT )?%([\w.\-]+) = (\([^()]*\)|[a-z0-9]+\[[\d,]*\]"
                    r"(?:\{[^}]*\})?) ([a-z\-]+)\((.*)$")
_ARRAY = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_FREE = {"parameter", "constant", "get-tuple-element", "bitcast", "tuple",
         "partition-id", "replica-id", "after-all"}
# ops that only move or retype data: an eager step takes a view of a
# period of a stacked weight, keeps a dtype, and writes a cache row in
# place where XLA slices, converts, transposes and concatenates copies
LAYOUT = frozenset({"convert", "bitcast", "copy", "slice", "dynamic-slice",
                    "transpose", "reshape", "concatenate",
                    "dynamic-update-slice"})
_DOT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_BATCH = re.compile(r"lhs_batch_dims=\{([\d,]*)\}")
_EINSUM = re.compile(r"([a-z]+,[a-z]+->[a-z]+)\)*/dot_general")
_WINDOW = re.compile(r"window=\{size=([\dx]+)")
_LABELS = re.compile(r"dim_labels=([\w]+)_")
_GROUPS = re.compile(r"feature_group_count=(\d+)")
_FROM_DOT = re.compile(r'op_name="[^"]*dot_general"')


def _dims(shape):
    return [int(d) for d in _ARRAY.match(shape).group(2).split(",") if d]


def _size(shape):
    return sum(_ITEM[t] * math.prod(int(d) for d in dims.split(",") if d)
               for t, dims in _ARRAY.findall(shape) if t in _ITEM)


def _item(shape):
    arrays = _ARRAY.findall(shape)
    return _ITEM.get(arrays[0][0]) if len(arrays) == 1 else None


def parse(hlo):
    """({computation: {instruction: fields}}, the entry's name); fields
    ``root``, ``shape``, ``op``, ``operands``, ``args`` (the text in the
    op's parentheses), ``attrs`` (the text after) and ``calls``."""
    comps, cur, entry = {}, None, None
    for line in hlo.splitlines():
        head = _HEAD.match(line)
        if head:
            cur = comps.setdefault(head.group(2), {})
            entry = head.group(2) if head.group(1) else entry
            continue
        m = _INSTR.match(line)
        if m is None or cur is None:
            continue
        rest, depth, i = m.group(5), 1, 0
        while depth:
            depth += {"(": 1, ")": -1}.get(rest[i], 0)
            i += 1
        calls = re.search(r"calls=%([\w.\-]+)", rest[i:])
        cur[m.group(2)] = dict(
            root=bool(m.group(1)), shape=m.group(3), op=m.group(4),
            args=rest[:i - 1],
            operands=re.findall(r"%([\w.\-]+)", rest[:i - 1]),
            attrs=rest[i:], calls=calls and calls.group(1))
    return comps, entry


def conv_flops(hlo, found=None):
    """2 × output elements × window size × input features ÷
    ``feature_group_count`` of every ``convolution`` of the module (padded
    window positions included, as a kernel computes them; XLA's own count
    leaves the positions in the padding out), each appended to ``found``
    (if given) as ("convolution", lhs dims, rhs dims, output dims,
    FLOPs)."""
    comps, _ = parse(hlo)
    total = 0
    for body in comps.values():
        for ins in body.values():
            if ins["op"] != "convolution":
                continue
            lhs = _dims(body[ins["operands"][0]]["shape"])
            window = _WINDOW.search(ins["attrs"])
            size = math.prod(int(d) for d in window.group(1).split("x")) \
                if window else 1
            features = lhs[_LABELS.search(ins["attrs"]).group(1).index("f")]
            groups = _GROUPS.search(ins["attrs"])
            flops = (2 * math.prod(_dims(ins["shape"])) * size * features
                     // (int(groups.group(1)) if groups else 1))
            total += flops
            if found is not None:
                found.append(("convolution", lhs,
                              _dims(body[ins["operands"][1]]["shape"]),
                              _dims(ins["shape"]), flops))
    return total


def _rewritten_dot_flops(hlo, found=None):
    """2 per element of every ``multiply`` whose metadata names a
    ``dot_general``: XLA rewrites a dot whose contraction has size 1 into
    a broadcast multiply, and a multiply XLA makes of a dot holds one
    element per product."""
    comps, _ = parse(hlo)
    total = 0
    for body in comps.values():
        for ins in body.values():
            if ins["op"] == "multiply" and _FROM_DOT.search(ins["attrs"]):
                flops = 2 * math.prod(_dims(ins["shape"]))
                total += flops
                if found is not None:
                    found.append(("multiply", _dims(
                        body[ins["operands"][0]]["shape"]), _dims(
                        body[ins["operands"][1]]["shape"]),
                        _dims(ins["shape"]), flops))
    return total


def dot_flops(hlo, batch=None, found=None, conv=False):
    """2·M·N·K of every ``dot`` of the module. With ``batch``, of the dots
    with a batch dimension of that size only, each appended to ``found``
    (if given) as (the einsum its ``op_name`` names, or None where XLA
    made the dot, lhs dims, rhs dims, output dims, FLOPs). With ``conv``
    (and no ``batch``), the products of the whole module: the dots, each
    appended to ``found`` as ("dot", lhs dims, rhs dims, output dims,
    FLOPs), plus :func:`conv_flops` and the dots XLA rewrote into a
    multiply (:func:`_rewritten_dot_flops`), listed there alike."""
    comps, _ = parse(hlo)
    total = 0
    for body in comps.values():
        for ins in body.values():
            if ins["op"] != "dot":
                continue
            lhs = _dims(body[ins["operands"][0]]["shape"])
            if batch is not None:
                b = _BATCH.search(ins["attrs"])
                if not b or batch not in [lhs[int(i)] for i in
                                          filter(None, b.group(1).split(","))]:
                    continue
            k = math.prod(lhs[int(i)] for i in filter(
                None, _DOT.search(ins["attrs"]).group(1).split(",")))
            flops = 2 * k * math.prod(_dims(ins["shape"]))
            total += flops
            if found is not None and (batch is not None or conv):
                eq = _EINSUM.search(ins["attrs"])
                found.append(("dot" if conv else eq and eq.group(1), lhs,
                              _dims(body[ins["operands"][1]]["shape"]),
                              _dims(ins["shape"]), flops))
    if conv:
        total += conv_flops(hlo, found) + _rewritten_dot_flops(hlo, found)
    return total


def _param_read(body, name):
    """``HloCostAnalysis::FusionParameterReadBytes``."""
    full, total, shared = _size(body[name]["shape"]), 0, False
    for user in body.values():
        if name not in user["operands"]:
            continue
        first = user["operands"][0] == name
        if user["op"] == "slice":
            total += _size(user["shape"])
        elif user["op"] == "dynamic-slice":
            total += _size(user["shape"]) if first else full
        elif user["op"] == "dynamic-update-slice":
            total += _size(body[user["operands"][1]]["shape"]) if first \
                else full
        elif user["op"] in ("broadcast", "reshape"):
            total += full
        elif not shared:
            shared = True
            total += full
    return total


def _written(body):
    root = next(i for i in body.values() if i["root"])
    outs = [body[o] for o in root["operands"]] if root["op"] == "tuple" \
        else [root]
    return sum(_size(body[o["operands"][1]]["shape"])
               if o["op"] == "dynamic-update-slice" else _size(o["shape"])
               for o in outs)


def hlo_bytes(hlo, layout=True):
    """The module's bytes accessed, XLA's rules (see the module's
    docstring). ``layout=False``: without the :data:`LAYOUT` ops, alone or
    fused only with each other. Such an op's output stands for its data
    operand, read at that operand's element width (a converted weight is
    read as the weight, a period's slice as that much of the stacked
    weight); a dynamic-update-slice among them counts its update read and
    written, the write an eager step does in place."""
    comps, entry = parse(hlo)

    def is_layout(ins):
        if ins["op"] == "fusion":
            return all(i["op"] in LAYOUT or i["op"] in ("parameter",
                                                         "constant")
                       for i in comps[ins["calls"]].values())
        return ins["op"] in LAYOUT

    def cost(name):
        body, width = comps[name], {}

        def read(o, nbytes):
            own = _item(body[o]["shape"])
            return nbytes * width[o] / own if o in width and own else nbytes

        def one(name, ins):
            op, operands = ins["op"], ins["operands"]
            if not layout and is_layout(ins):
                if operands:
                    data = max(operands, key=lambda o: _size(body[o]["shape"]))
                    width[name] = width.get(data, _item(body[data]["shape"]))
                inner = comps[ins["calls"]] if op == "fusion" else body
                return sum(2 * _size(inner[i["operands"][1]]["shape"])
                           for i in (inner.values() if op == "fusion"
                                     else [ins])
                           if i["op"] == "dynamic-update-slice")
            if op == "while":
                return sum(cost(re.search(k + r"=%([\w.\-]+)",
                                          ins["attrs"]).group(1))
                           for k in ("body", "condition"))
            if op in _FREE:
                return 0
            if op == "fusion":
                fused = comps[ins["calls"]]
                return _written(fused) + sum(
                    read(operands[int(i["args"])], _param_read(fused, p))
                    for p, i in fused.items() if i["op"] == "parameter")
            if op in ("slice", "dynamic-slice"):
                return read(operands[0], _size(ins["shape"])) \
                    + _size(ins["shape"]) \
                    + sum(_size(body[o]["shape"]) for o in operands[1:])
            return _size(ins["shape"]) + sum(
                read(o, _size(body[o]["shape"])) for o in operands)
        return sum(one(n, ins) for n, ins in body.items())
    return cost(entry)

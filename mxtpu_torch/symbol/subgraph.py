"""Subgraph / backend-partition framework (counterpart of
``mxtpu/symbol/subgraph.py``).

Reference: ``src/operator/subgraph/subgraph_property.h:54-155`` (the
``SubgraphSelector`` / ``SubgraphProperty`` pair + registry),
``partition_graph.cc`` (the partition pass), and
``default_subgraph_property.cc`` (matched region executes as a CachedOp).

The partition pass rewrites the Symbol DAG (symbol.py): a matched region
collapses into ONE ``_subgraph_exec`` node whose attr carries the
sub-symbol JSON (ops/subgraph_ops.py runs it inline: inside an executor's
capture a region is part of the outer CUDA graph, since a capture cannot
nest). Properties can instead emit any replacement node: the bundled
``FlashAttentionProperty`` pattern-matches the unfused
softmax(QK^T * scale)V chain and swaps in the flash-attention kernel
(``mxtpu_torch/csrc/flash_attention.cu``), the counterpart of the
reference's MKLDNN conv-fusion property (src/operator/subgraph/mkldnn/).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .symbol import Symbol, _ARG, _Counter, _Node, _topo

__all__ = ["SubgraphSelector", "SubgraphProperty", "DefaultSubgraphProperty",
           "FlashAttentionProperty", "register_subgraph_property",
           "get_subgraph_property", "partition"]

log = logging.getLogger(__name__)


class SubgraphSelector:
    """Growth policy for one candidate region (ref: subgraph_property.h:54).

    ``select`` seeds a region at a node; ``select_input``/``select_output``
    decide whether to grow across an edge. Defaults grow nothing.
    """

    def select(self, node) -> bool:
        raise NotImplementedError

    def select_input(self, node, input_node) -> bool:
        return False

    def select_output(self, node, output_node) -> bool:
        return False


class SubgraphProperty:
    """A named partition rule (ref: subgraph_property.h:100-155)."""

    name = None

    def create_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def create_subgraph_node(self, subsym, input_names, external_inputs,
                             name):
        """Build the replacement node, or return None to leave the region
        untouched. Default: a ``_subgraph_exec`` op that runs the
        sub-symbol (the reference's default property runs it as a
        CachedOp)."""
        node = _Node("_subgraph_exec", name,
                     attrs={"subgraph_json": subsym.tojson(),
                            "input_names": tuple(input_names),
                            "n_outputs": len(subsym._heads)},
                     inputs=list(external_inputs),
                     pos_template=[_ARG] * len(external_inputs),
                     num_outputs=len(subsym._heads))
        return node


_PROPERTIES = {}


def register_subgraph_property(prop: SubgraphProperty):
    """Register a property under ``prop.name``
    (ref: MXNET_REGISTER_SUBGRAPH_PROPERTY)."""
    if not prop.name:
        raise MXNetError("subgraph property needs a name")
    _PROPERTIES[prop.name] = prop
    return prop


def get_subgraph_property(name):
    if name not in _PROPERTIES:
        raise MXNetError("unknown subgraph property %r (registered: %s)"
                         % (name, sorted(_PROPERTIES)))
    return _PROPERTIES[name]


def _consumers(nodes):
    out = {}
    for n in nodes:
        for inp, idx in n.inputs:
            out.setdefault(id(inp), []).append(n)
    return out


def _region_is_convex(region, consumers):
    """No path may leave the region and re-enter it (the reference's cycle
    check in partition_graph.cc) — otherwise the collapsed node would form
    a cycle with the outside graph."""
    region_ids = {id(n) for n in region}
    # nodes reachable strictly downstream of the region through >=1
    # outside node must not include region members
    outside_frontier = []
    for n in region:
        for c in consumers.get(id(n), []):
            if id(c) not in region_ids:
                outside_frontier.append(c)
    seen = set()
    stack = list(outside_frontier)
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if id(n) in region_ids:
            return False
        for c in consumers.get(id(n), []):
            stack.append(c)
    return True


def partition(symbol: Symbol, prop_or_name) -> Symbol:
    """Partition pass (ref: partition_graph.cc BuildSubgraph): grow regions
    per the property's selector, collapse each into a replacement node,
    return a new Symbol. The input symbol is not modified."""
    prop = (get_subgraph_property(prop_or_name)
            if isinstance(prop_or_name, str) else prop_or_name)

    # work on a cloned graph so the caller's symbol stays intact
    sym = _clone(symbol)
    nodes = _topo(sym._heads)
    consumers = _consumers(nodes)
    assigned = set()
    regions = []
    for seed in nodes:
        if seed.is_var() or id(seed) in assigned:
            continue
        sel = prop.create_selector()
        if not sel.select(seed):
            continue
        region = [seed]
        region_ids = {id(seed)}
        frontier = [seed]
        while frontier:
            n = frontier.pop()
            for inp, _idx in n.inputs:
                if inp.is_var() or id(inp) in region_ids \
                        or id(inp) in assigned:
                    continue
                if sel.select_input(n, inp):
                    region.append(inp)
                    region_ids.add(id(inp))
                    frontier.append(inp)
            for c in consumers.get(id(n), []):
                if id(c) in region_ids or id(c) in assigned:
                    continue
                if sel.select_output(n, c):
                    region.append(c)
                    region_ids.add(id(c))
                    frontier.append(c)
        if not _region_is_convex(region, consumers):
            log.warning("subgraph property %s: region at %s is not convex; "
                        "skipped", prop.name, seed.name)
            continue
        assigned |= region_ids
        regions.append(region)

    for region in regions:
        _collapse(sym, region, prop, consumers)
    return sym


def _clone(symbol):
    from .symbol import load_json
    return load_json(symbol.tojson())


def _collapse(sym, region, prop, _consumers_stale):
    """Replace `region` (a set of nodes of sym) with one property node."""
    region_ids = {id(n) for n in region}
    order = [n for n in _topo(sym._heads) if id(n) in region_ids]

    # external input edges, in first-use order (deduped per (node, idx))
    ext_edges = []
    edge_key = {}
    for n in order:
        for inp, idx in n.inputs:
            if id(inp) in region_ids:
                continue
            k = (id(inp), idx)
            if k not in edge_key:
                edge_key[k] = len(ext_edges)
                ext_edges.append((inp, idx))

    # region outputs: head edges or edges consumed outside the region
    out_edges = []
    out_key = {}
    all_nodes = _topo(sym._heads)
    for n in all_nodes:
        if id(n) in region_ids:
            continue
        for inp, idx in n.inputs:
            if id(inp) in region_ids and (id(inp), idx) not in out_key:
                out_key[(id(inp), idx)] = len(out_edges)
                out_edges.append((inp, idx))
    for h, idx in sym._heads:
        i = 0 if idx is None else idx
        if id(h) in region_ids and (id(h), i) not in out_key:
            out_key[(id(h), i)] = len(out_edges)
            out_edges.append((h, i))

    # build the sub-symbol: clone region nodes with external edges as vars
    input_names = []
    var_nodes = {}
    for j, (inp, idx) in enumerate(ext_edges):
        nm = inp.name if inp.is_var() and idx == 0 else "sg_in%d" % j
        input_names.append(nm)
        var_nodes[(id(inp), idx)] = _Node(None, nm, {})
    clones = {}
    for n in order:
        c = _Node(n.op, n.name, dict(n.attrs), [],
                  list(n.pos_template), list(n.kw_arrays),
                  num_outputs=n.num_outputs)
        for inp, idx in n.inputs:
            if id(inp) in region_ids:
                c.inputs.append((clones[id(inp)], idx))
            else:
                c.inputs.append((var_nodes[(id(inp), idx)], 0))
        clones[id(n)] = c
    subsym = Symbol([(clones[id(n)], i) for n, i in out_edges])

    name = "sg_%s%d" % (prop.name, _Counter.next("sg_" + prop.name))
    new_node = prop.create_subgraph_node(subsym, input_names, ext_edges,
                                         name)
    if new_node is None:  # property declined: leave the region as-is
        return

    # rewire consumers and heads to the replacement node's outputs
    for n in _topo(sym._heads):
        if id(n) in region_ids:
            continue
        n.inputs = [
            (new_node, out_key[(id(inp), idx)])
            if id(inp) in region_ids else (inp, idx)
            for inp, idx in n.inputs]
    sym._heads = [
        (new_node, out_key[(id(h), 0 if idx is None else idx)])
        if id(h) in region_ids else (h, idx)
        for h, idx in sym._heads]


# ------------------------------------------------------------ default prop
class _AllOpsSelector(SubgraphSelector):
    def select(self, node):
        return True

    def select_input(self, node, input_node):
        return True

    def select_output(self, node, output_node):
        return True


class DefaultSubgraphProperty(SubgraphProperty):
    """Collapse every connected op region into one ``_subgraph_exec`` node
    (ref: default_subgraph_property.cc — subgraph as CachedOp)."""

    name = "default"

    def create_selector(self):
        return _AllOpsSelector()


# ----------------------------------------------------- flash-attention prop
def _is_scalar_scale(node):
    """A mul/div applying one python scalar (the scalar aliases resolve to
    the broadcast ops with the literal captured in pos_template). Division
    must have the ARRAY on the left — scalar/x is a reciprocal, not a
    scale."""
    if node is None or node.op not in ("broadcast_mul", "broadcast_div",
                                       "_mul_scalar", "_div_scalar"):
        return False
    if sum(1 for x in node.pos_template if x is _ARG) != 1:
        return False
    if "div" in node.op and (not node.pos_template
                             or node.pos_template[0] is not _ARG):
        return False
    return True


class _AttentionSelector(SubgraphSelector):
    """Matches softmax(batch_dot(q, k) [* scale]) @ v chains."""

    def select(self, node):
        # seed at the softmax over attention scores
        return node.op == "softmax"

    def select_input(self, node, input_node):
        # grow upstream: the scores batch_dot and an optional scalar scale
        if node.op == "softmax" or _is_scalar_scale(node):
            return input_node.op == "batch_dot" \
                or _is_scalar_scale(input_node)
        return False

    def select_output(self, node, output_node):
        # grow downstream from softmax into the probs @ v batch_dot
        return node.op == "softmax" and output_node.op == "batch_dot"


class FlashAttentionProperty(SubgraphProperty):
    """Swap matched attention patterns for the flash-attention kernel
    (ops/pallas/flash_attention.py) — the counterpart of the reference's
    MKLDNN fusion properties."""

    name = "flash_attention"

    def create_selector(self):
        return _AttentionSelector()

    def create_subgraph_node(self, subsym, input_names, external_inputs,
                             name):
        info = _match_attention(subsym, input_names)
        if info is None:
            # pattern incomplete (e.g. a lone classifier softmax): leave
            # the region untouched — an opaque subgraph gains nothing
            return None
        q_i, k_i, v_i, scale, transpose_b = info
        node = _Node("_sg_flash_attention", name,
                     attrs={"scale": scale, "transpose_b": transpose_b},
                     inputs=[external_inputs[q_i], external_inputs[k_i],
                             external_inputs[v_i]],
                     pos_template=[_ARG, _ARG, _ARG],
                     num_outputs=1)
        return node


def _match_attention(subsym, input_names):
    """Validate the region is exactly softmax(bdot(q,k)*scale) @ v and
    return (q_idx, k_idx, v_idx, scale, transpose_b) into the region's
    external input list, else None."""
    nodes = _topo(subsym._heads)
    if len(subsym._heads) != 1:
        return None
    final, _ = subsym._heads[0]
    if final.op != "batch_dot":
        return None
    # the probs @ v contraction must be the plain orientation
    if final.attrs.get("transpose_a") or final.attrs.get("transpose_b"):
        return None
    for n in nodes:
        if n.is_var():
            continue
        if n.op not in ("batch_dot", "softmax") and not _is_scalar_scale(n):
            return None
    # walk: final(probs, v); probs = softmax(x); x = [scale ops](scores);
    # scores = batch_dot(q, k)
    (probs_n, _), (v_n, _) = final.inputs[0], final.inputs[1]
    if probs_n.op != "softmax" or not v_n.is_var():
        return None
    # the flash kernel softmaxes over the key axis (last): any explicit
    # non-default softmax axis disqualifies the match
    if probs_n.attrs.get("axis", -1) != -1:
        return None
    cur, _ = probs_n.inputs[0]
    scale = 1.0
    while _is_scalar_scale(cur):
        s = None
        for x in cur.pos_template:
            if x is not _ARG:
                s = float(x)
        if s is None:
            s = float(cur.attrs.get("b", 1.0))
        scale = scale * s if "mul" in cur.op else scale / s
        cur, _ = cur.inputs[0]
    if cur.op != "batch_dot":
        return None
    if cur.attrs.get("transpose_a"):  # q must be row-major queries
        return None
    (q_n, _), (k_n, _) = cur.inputs[0], cur.inputs[1]
    if not (q_n.is_var() and k_n.is_var()):
        return None
    transpose_b = bool(cur.attrs.get("transpose_b", False))
    idx = {nm: i for i, nm in enumerate(input_names)}
    return (idx[q_n.name], idx[k_n.name], idx[v_n.name], scale, transpose_b)


register_subgraph_property(DefaultSubgraphProperty())
register_subgraph_property(FlashAttentionProperty())

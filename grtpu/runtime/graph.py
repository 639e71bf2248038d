"""Flowgraph builder: connect / hierarchy / flatten / validate / sort.

Reference semantics re-designed:
  * gnuradio-core/src/lib/runtime/gr_flowgraph.{h,cc} — edge list,
    validation (signature type check gr_flowgraph.cc:94-111, port contiguity
    :229), topological_sort (:402), partition into weakly-connected
    components (:331).
  * gnuradio-core/src/lib/runtime/gr_hier_block2{,_detail}.{h,cc} —
    hierarchical containers whose ``flatten()`` recursively resolves
    hier→leaf edges (gr_hier_block2_detail.cc:402-471).

Difference: flattening here produces a *static dataflow DAG* that
is traced once into a single XLA program by the executor — there is no
scheduler object, no buffer allocation, no threads.  Cycles are disallowed at
the graph level (feedback belongs inside a block as a ``lax.scan``), matching
XLA's acyclic dataflow model.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Union

from grtpu.runtime.block import Block, Port


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """(block, port index) — analog of gr_endpoint (gr_flowgraph.h)."""

    block: "Node"
    port: int = 0

    def __repr__(self):
        return f"{self.block.name}:{self.port}"


Node = Union[Block, "HierBlock", "Pad"]


class Pad:
    """External connection point of a Graph/HierBlock (an input or output pad).

    The analog of the implicit "self" ports of gr_hier_block2: connecting
    ``graph.input(i)`` to a block is the reference's
    ``connect(self, i, block, j)``.
    """

    def __init__(self, kind: str, index: int, port: Port, owner: "Graph"):
        assert kind in ("in", "out")
        self.kind = kind
        self.index = index
        self.port = port
        self.owner = owner
        self.name = f"{'pad_in' if kind == 'in' else 'pad_out'}_{index}"

    def __repr__(self):
        return f"<Pad {self.name}>"


@dataclasses.dataclass(frozen=True)
class Edge:
    src: Endpoint
    dst: Endpoint


def _as_endpoint(x) -> Endpoint:
    if isinstance(x, Endpoint):
        return x
    if isinstance(x, (Block, HierBlock, Pad)):
        return Endpoint(x, 0)
    if isinstance(x, tuple) and len(x) == 2:
        return Endpoint(x[0], x[1])
    raise TypeError(f"cannot interpret {x!r} as a flowgraph endpoint")


def _src_port(node: Node, i: int) -> Port:
    if isinstance(node, Pad):
        if node.kind != "in":
            raise ValueError(f"{node} is an output pad; it cannot be a source")
        return node.port
    return node.out_ports[i]


def _dst_port(node: Node, i: int) -> Port:
    if isinstance(node, Pad):
        if node.kind != "out":
            raise ValueError(f"{node} is an input pad; it cannot be a destination")
        return node.port
    return node.in_ports[i]


class Graph:
    """A flowgraph under construction.

    ``connect(a, b, c, ...)`` chains endpoints pairwise, like
    gr.top_block.connect.  Endpoints are blocks (port 0), ``(block, port)``
    tuples, or :class:`Endpoint` objects.  Graphs may contain
    :class:`HierBlock` nodes; :meth:`flatten` resolves them to leaf blocks.
    """

    def __init__(self, name: str = "graph"):
        self.name = name
        self.edges: List[Edge] = []
        self._in_pads: List[Pad] = []
        self._out_pads: List[Pad] = []

    # -- external pads ------------------------------------------------------
    def add_input(self, port: Port) -> Pad:
        pad = Pad("in", len(self._in_pads), port, self)
        self._in_pads.append(pad)
        return pad

    def add_output(self, port: Port) -> Pad:
        pad = Pad("out", len(self._out_pads), port, self)
        self._out_pads.append(pad)
        return pad

    def input(self, i: int = 0) -> Pad:
        return self._in_pads[i]

    def output(self, i: int = 0) -> Pad:
        return self._out_pads[i]

    @property
    def n_inputs(self):
        return len(self._in_pads)

    @property
    def n_outputs(self):
        return len(self._out_pads)

    # -- construction -------------------------------------------------------
    def connect(self, *points):
        """Chain-connect endpoints: connect(a, b, c) == a->b, b->c."""
        if len(points) < 2:
            raise ValueError("connect needs at least two endpoints")
        eps = [_as_endpoint(p) for p in points]
        for s, d in zip(eps[:-1], eps[1:]):
            self._connect_one(s, d)
        return self

    def _connect_one(self, src: Endpoint, dst: Endpoint):
        sp = _src_port(src.block, src.port)
        dp = _dst_port(dst.block, dst.port)
        if not sp.compatible(dp):
            raise ValueError(
                f"type mismatch connecting {src} ({sp}) -> {dst} ({dp})"
            )
        for e in self.edges:
            if e.dst == dst:
                raise ValueError(f"destination {dst} already connected")
        self.edges.append(Edge(src, dst))

    # -- flatten ------------------------------------------------------------
    def flatten(self) -> "FlatGraph":
        """Resolve HierBlock nodes to a leaf-block DAG.

        Mirrors gr_hier_block2_detail::flatten_aux
        (gr_hier_block2_detail.cc:402-471): each hier node's internal edges
        are inlined and its pad endpoints are substituted with whatever
        connects to them on the outside/inside.
        """
        edges = list(self.edges)
        # Iteratively inline hier blocks until only leaf Blocks and our own
        # Pads remain.
        while True:
            hier = None
            for e in edges:
                for node in (e.src.block, e.dst.block):
                    if isinstance(node, HierBlock):
                        hier = node
                        break
                if hier:
                    break
            if hier is None:
                break
            edges = self._inline_hier(edges, hier)

        flat = FlatGraph(self.name, edges, self._in_pads, self._out_pads)
        flat.validate()
        return flat

    @staticmethod
    def _inline_hier(edges: List[Edge], hier: "HierBlock") -> List[Edge]:
        g = hier.graph
        # What the hier's internal pads resolve to:
        #   in-pad i  -> endpoints inside g fed from it (g.input(i) as src)
        #   out-pad i -> the single endpoint inside g driving it
        internal = list(g.edges)
        inner_dsts: Dict[int, List[Endpoint]] = defaultdict(list)
        inner_srcs: Dict[int, Endpoint] = {}
        rest: List[Edge] = []
        for e in internal:
            if isinstance(e.src.block, Pad) and e.src.block.owner is g:
                inner_dsts[e.src.block.index].append(e.dst)
            elif isinstance(e.dst.block, Pad) and e.dst.block.owner is g:
                inner_srcs[e.dst.block.index] = e.src
            else:
                rest.append(e)

        out: List[Edge] = list(rest)
        for e in edges:
            s, d = e.src, e.dst
            if s.block is hier and d.block is hier:
                # passthrough hier->hier on same node (rare)
                src = inner_srcs[s.port]
                for dd in inner_dsts[d.port]:
                    out.append(Edge(src, dd))
            elif d.block is hier:
                for dd in inner_dsts[d.port]:
                    out.append(Edge(s, dd))
            elif s.block is hier:
                out.append(Edge(inner_srcs[s.port], d))
            else:
                out.append(e)
        return out


class HierBlock:
    """A reusable hierarchical block wrapping an internal :class:`Graph`.

    Analog of gr_hier_block2 (gr_hier_block2.h): build ``self.graph``,
    declare pads with ``graph.add_input/add_output``, then use the HierBlock
    as a node in an outer graph.
    """

    _instance_counter = [0]

    def __init__(self, name: str | None = None):
        HierBlock._instance_counter[0] += 1
        self.uid = 10_000_000 + HierBlock._instance_counter[0]
        self.name = name or f"{type(self).__name__}_{self.uid}"
        self.graph = Graph(self.name + ".inner")

    @property
    def in_ports(self) -> Tuple[Port, ...]:
        return tuple(p.port for p in self.graph._in_pads)

    @property
    def out_ports(self) -> Tuple[Port, ...]:
        return tuple(p.port for p in self.graph._out_pads)

    def connect(self, *points):
        return self.graph.connect(*points)

    def input(self, i: int = 0):
        return self.graph.input(i)

    def output(self, i: int = 0):
        return self.graph.output(i)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class FlatGraph:
    """A validated leaf-block DAG ready for compilation.

    Analog of gr_flat_flowgraph, but instead of allocating vmcircbufs and
    block_details (gr_flat_flowgraph.cc:69-122) it is consumed by
    :class:`grtpu.runtime.executor.StreamExecutor`, which traces the whole
    DAG into one jitted function.
    """

    def __init__(self, name, edges: Sequence[Edge], in_pads, out_pads):
        self.name = name
        self.edges = list(edges)
        self.in_pads = list(in_pads)
        self.out_pads = list(out_pads)
        self.blocks = self._collect_blocks()

    def _collect_blocks(self) -> List[Block]:
        seen: Dict[int, Block] = {}
        for e in self.edges:
            for node in (e.src.block, e.dst.block):
                if isinstance(node, Block):
                    seen.setdefault(node.uid, node)
        return list(seen.values())

    # -- queries ------------------------------------------------------------
    def upstream_of(self, block: Block) -> Dict[int, Edge]:
        """in-port -> edge feeding it."""
        return {
            e.dst.port: e
            for e in self.edges
            if e.dst.block is block
        }

    def downstream_of(self, block: Block) -> List[Edge]:
        return [e for e in self.edges if e.src.block is block]

    # -- validation ---------------------------------------------------------
    def validate(self):
        """Type/arity checks, analog of gr_flowgraph::validate
        (gr_flowgraph.cc:94-111, port contiguity :229)."""
        for b in self.blocks:
            ups = self.upstream_of(b)
            for i in range(len(b.in_ports)):
                if i not in ups:
                    raise ValueError(f"{b.name}: input port {i} unconnected")
            for i in ups:
                if i >= len(b.in_ports):
                    raise ValueError(f"{b.name}: no such input port {i}")
        for e in self.edges:
            if isinstance(e.src.block, Pad) and isinstance(e.dst.block, Pad):
                continue
        self.topological_order()  # raises on cycles

    def topological_order(self) -> List[Block]:
        """Kahn topological sort (analog of gr_flowgraph.cc:402)."""
        indeg = {b.uid: 0 for b in self.blocks}
        adj: Dict[int, List[int]] = defaultdict(list)
        byid = {b.uid: b for b in self.blocks}
        for e in self.edges:
            if isinstance(e.src.block, Block) and isinstance(e.dst.block, Block):
                adj[e.src.block.uid].append(e.dst.block.uid)
                indeg[e.dst.block.uid] += 1
        ready = sorted([u for u, d in indeg.items() if d == 0])
        order = []
        while ready:
            u = ready.pop(0)
            order.append(byid[u])
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(self.blocks):
            raise ValueError(
                "flowgraph has a cycle; feedback must live inside a block "
                "as a lax.scan recurrence"
            )
        return order

    def partition(self) -> List[List[Block]]:
        """Weakly-connected components (analog of gr_flowgraph.cc:331)."""
        parent = {b.uid: b.uid for b in self.blocks}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in self.edges:
            if isinstance(e.src.block, Block) and isinstance(e.dst.block, Block):
                pu, pv = find(e.src.block.uid), find(e.dst.block.uid)
                if pu != pv:
                    parent[pu] = pv
        groups: Dict[int, List[Block]] = defaultdict(list)
        for b in self.blocks:
            groups[find(b.uid)].append(b)
        return list(groups.values())

"""De Bruijn graph local assembler.

Behavior parity with reference debruijn_graph.{h,cc}:
  * k is scanned from min_k..max_k (step_k) — first the reference alone is
    checked for repeated k-mers (KMinMaxFromReference,
    debruijn_graph.cc:215-242), then full graphs are built until one is
    acyclic (Build, :244-267);
  * read k-mers contribute only runs of canonical, high-quality bases, and
    only for reads with mapq >= min_mapq (AddEdgesForRead, :304-358);
  * pruning removes non-ref edges with weight < min_edge_weight, then all
    vertices not on a source->sink path (Prune, :451-...);
  * candidate haplotypes are all source->sink paths (BFS, capped at
    max_num_paths; exceeding the cap returns NO haplotypes, :359-394),
    sorted lexicographically (:406-413).

Implementation is dict-based Python (no boost): vertices are k-mer strings,
edges a dict keyed by (from, to) with [weight, is_ref]. The port's copy of
`deepvariant_tpu.realign.debruijn_graph`, without that package's dispatch
to its native assembler (same haplotype lists either way).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deepvariant_tpu_torch.core.types import Read
from deepvariant_tpu_torch.realign.config import DeBruijnGraphOptions

_CANONICAL = frozenset("ACGT")


class DeBruijnGraph:
    """One assembled window at a fixed k."""

    def __init__(self, ref: str, reads: Sequence[Read],
                 options: DeBruijnGraphOptions, k: int):
        assert 0 < k < len(ref)
        self.options = options
        self.k = k
        # adjacency: vertex -> list of successors; edges: (u,v) -> [w, is_ref]
        self.succ: Dict[str, List[str]] = {}
        self.pred: Dict[str, List[str]] = {}
        self.edges: Dict[Tuple[str, str], List] = {}
        self._add_edges_for_reference(ref)
        self.source = ref[:k]
        self.sink = ref[len(ref) - k:]
        for read in reads:
            if read.mapping_quality >= options.min_mapq:
                self._add_edges_for_read(read)

    # -- construction -------------------------------------------------------

    def _ensure_vertex(self, kmer: str):
        if kmer not in self.succ:
            self.succ[kmer] = []
            self.pred[kmer] = []

    def _add_edge(self, u: str, v: str, is_ref: bool):
        e = self.edges.get((u, v))
        if e is None:
            self.edges[(u, v)] = [1, is_ref]
            self.succ[u].append(v)
            self.pred[v].append(u)
        else:
            e[0] += 1
            e[1] = e[1] or is_ref

    def _add_kmers_and_edges(self, bases: str, start: int, end: int,
                             is_ref: bool):
        # Adds edges between consecutive kmers at [start..end] (inclusive
        # end index of the last *source* kmer) — AddKmersAndEdges semantics.
        if end > 0:
            prev = bases[start:start + self.k]
            self._ensure_vertex(prev)
            for i in range(start + 1, end + 1):
                cur = bases[i:i + self.k]
                self._ensure_vertex(cur)
                self._add_edge(prev, cur, is_ref)
                prev = cur

    def _add_edges_for_reference(self, ref: str):
        self._add_kmers_and_edges(ref, 0, len(ref) - self.k, True)

    def _add_edges_for_read(self, read: Read):
        bases = read.aligned_sequence.upper()
        quals = read.aligned_quality
        min_q = self.options.min_base_quality
        n = len(bases)

        def next_bad_position(start: int) -> int:
            for i in range(start, n):
                if bases[i] not in _CANONICAL or quals[i] < min_q:
                    return i
            return n

        stop = n - self.k
        i = 0
        while i < stop:
            bad = next_bad_position(i)
            self._add_kmers_and_edges(bases, i, bad - self.k, False)
            i = bad + 1

    # -- analysis -----------------------------------------------------------

    def has_cycle(self) -> bool:
        """Iterative DFS three-color cycle detection."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {v: WHITE for v in self.succ}
        for root in self.succ:
            if color[root] != WHITE:
                continue
            stack = [(root, iter(self.succ[root]))]
            color[root] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color[nxt] == GRAY:
                        return True
                    if color[nxt] == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, iter(self.succ[nxt])))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return False

    def _remove_vertex(self, v: str):
        for u in self.pred.pop(v, []):
            self.succ[u] = [x for x in self.succ[u] if x != v]
            self.edges.pop((u, v), None)
        for w in self.succ.pop(v, []):
            self.pred[w] = [x for x in self.pred[w] if x != v]
            self.edges.pop((v, w), None)

    def prune_lite(self):
        isolated = [
            v for v in self.succ
            if not self.succ[v] and not self.pred[v]
        ]
        for v in isolated:
            self.succ.pop(v)
            self.pred.pop(v)

    def prune(self):
        """Drop weak non-ref edges, keep only source->sink-reachable."""
        for (u, v), (w, is_ref) in list(self.edges.items()):
            if not is_ref and w < self.options.min_edge_weight:
                del self.edges[(u, v)]
                self.succ[u] = [x for x in self.succ[u] if x != v]
                self.pred[v] = [x for x in self.pred[v] if x != u]

        def reachable(start: str, adj: Dict[str, List[str]]) -> Set[str]:
            seen = {start}
            dq = deque([start])
            while dq:
                node = dq.popleft()
                for nxt in adj.get(node, []):
                    if nxt not in seen:
                        seen.add(nxt)
                        dq.append(nxt)
            return seen

        fwd = reachable(self.source, self.succ)
        rev = reachable(self.sink, self.pred)
        keep = fwd & rev
        for v in [v for v in self.succ if v not in keep]:
            self._remove_vertex(v)

    # -- haplotypes ---------------------------------------------------------

    def candidate_paths(self) -> List[List[str]]:
        terminated: List[List[str]] = []
        extendable: deque = deque()
        if not self.succ.get(self.source):
            return []
        extendable.append([self.source])
        while extendable:
            if len(terminated) + len(extendable) > \
                    self.options.max_num_paths:
                return []
            path = extendable.popleft()
            for nxt in self.succ.get(path[-1], []):
                extended = path + [nxt]
                if nxt == self.sink or not self.succ.get(nxt):
                    terminated.append(extended)
                else:
                    extendable.append(extended)
        return terminated

    def haplotype_for_path(self, path: List[str]) -> str:
        hap = "".join(v[0] for v in path)
        if path:
            hap += path[-1][1:]
        return hap

    def candidate_haplotypes(self) -> List[str]:
        return sorted(
            self.haplotype_for_path(p) for p in self.candidate_paths()
        )


def _k_min_max_from_reference(
    ref: str, options: DeBruijnGraphOptions
) -> Tuple[int, int]:
    """First k with no repeated ref k-mer; (-1, max) if none works."""
    max_k = min(options.max_k, len(ref) - 1)
    for k in range(options.min_k, max_k + 1, options.step_k):
        seen = set()
        has_cycle = False
        for i in range(len(ref) - k + 1):
            kmer = ref[i:i + k]
            if kmer in seen:
                has_cycle = True
                break
            seen.add(kmer)
        if not has_cycle:
            return k, max_k
    return -1, max_k


def build(
    ref: str, reads: Sequence[Read], options: Optional[DeBruijnGraphOptions] = None
) -> Optional[DeBruijnGraph]:
    """Build an acyclic pruned graph, or None (DeBruijnGraph::Build)."""
    options = options or DeBruijnGraphOptions()
    ref = ref.upper()
    min_k, max_k = _k_min_max_from_reference(ref, options)
    if min_k < 0:
        return None
    for k in range(min_k, max_k + 1, options.step_k):
        graph = DeBruijnGraph(ref, reads, options, k)
        if graph.has_cycle():
            continue
        if options.disable_graph_pruning:
            graph.prune_lite()
        else:
            graph.prune()
        return graph
    return None


def assemble_haplotypes(
    ref: str, reads: Sequence[Read],
    options: Optional[DeBruijnGraphOptions] = None,
) -> Optional[List[str]]:
    """Sorted candidate haplotypes for a window, or None when no
    acyclic k exists."""
    options = options or DeBruijnGraphOptions()
    graph = build(ref, reads, options)
    if graph is None:
        return None
    return graph.candidate_haplotypes()

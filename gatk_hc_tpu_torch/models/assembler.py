"""Local re-assembly: read-threading De Bruijn graph + k-mer retry ladder.

Semantics mirror the reference assembler (assembler/assembler.hpp,
assembler/graph_wrapper.hpp) without Boost:

* duplicate k-mers (within the ref, or within any single read segment) get a
  fresh vertex per occurrence and are never registered for lookup
  (graph_wrapper.hpp:82-96, 251-261);
* read threading extends chains by matching the next k-mer's LAST base
  against existing out-edges (graph_wrapper.hpp:115-130);
* adding a sequence bumps counts backwards through unambiguous in-chains
  (graph_wrapper.hpp:98-113);
* cycle check runs a DFS over the pruned view (edge passes iff is_ref or
  count >= 2 or out_degree(source) == 1 in the *unpruned* graph)
  (graph_wrapper.hpp:56-61, 302-309);
* path enumeration is an exhaustive DFS source->sink with the same prune
  rule and no vertex revisits within a path (graph_wrapper.hpp:142-169);
* per-edge scores are log10(count / sum-of-on-path-out-counts)
  (graph_wrapper.hpp:185-199); haplotypes sort by score desc, cap 128, and
  each is SW-aligned to the window reference for offset+CIGAR
  (graph_wrapper.hpp:201-239).

The C++ native assembler in gatk_hc_tpu/native implements the same
semantics; tests differential-check the two.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..config import HCConfig
from ..io.sam import SAMRecord
from ..ops.sw import sw_align
from .haplotype import Haplotype

# Guard against pathological exponential path blowup; the reference has no
# such guard (it would hang).  Hitting this raises so callers notice.
MAX_ENUMERATED_PATHS = 200_000


class PathExplosionError(RuntimeError):
    """A region whose assembly graph enumerates >MAX_ENUMERATED_PATHS paths.

    The caller treats this (and only this) per-region failure as routine:
    skip the region with a warning instead of aborting a whole-genome run.
    Other native error codes (SW failure, arena overflow) are internal bugs
    and propagate as plain RuntimeError."""


class _Graph:
    def __init__(self, kmer_size: int, cfg: HCConfig):
        self.k = kmer_size
        self.cfg = cfg
        self.kmers: List[str] = []  # vertex id -> kmer
        self.out_edges: List[List[int]] = []  # vertex -> edge ids, insert order
        self.in_edges: List[List[int]] = []
        # edge arrays
        self.e_src: List[int] = []
        self.e_dst: List[int] = []
        self.e_count: List[int] = []
        self.e_is_ref: List[bool] = []
        self.unique_kmers: Dict[str, int] = {}
        self.dup_kmers: Set[str] = set()
        self.source = 0
        self.sink = 0

    # --- construction -----------------------------------------------------
    def _create_vertex(self, kmer: str) -> int:
        vid = len(self.kmers)
        self.kmers.append(kmer)
        self.out_edges.append([])
        self.in_edges.append([])
        if kmer not in self.dup_kmers:
            # std::map::emplace: first occurrence wins
            self.unique_kmers.setdefault(kmer, vid)
        return vid

    def _get_vertex(self, kmer: str) -> int:
        vid = self.unique_kmers.get(kmer)
        return vid if vid is not None else self._create_vertex(kmer)

    def _create_edge(self, u: int, v: int, is_ref: bool) -> None:
        eid = len(self.e_src)
        self.e_src.append(u)
        self.e_dst.append(v)
        self.e_count.append(1)
        self.e_is_ref.append(is_ref)
        self.out_edges[u].append(eid)
        self.in_edges[v].append(eid)

    def _increase_counts_backwards(self, v: int, kmer: str) -> None:
        while kmer:
            if len(self.in_edges[v]) != 1:
                return
            eid = self.in_edges[v][0]
            u = self.e_src[eid]
            if self.kmers[u][-1] != kmer[-1]:
                return
            self.e_count[eid] += 1
            v = u
            kmer = kmer[:-1]

    def _extend_chain(self, u: int, kmer: str, is_ref: bool) -> int:
        last = kmer[-1]
        for eid in self.out_edges[u]:
            v = self.e_dst[eid]
            if self.kmers[v][-1] == last:
                self.e_count[eid] += 1
                return v
        v = self._get_vertex(kmer)
        self._create_edge(u, v, is_ref)
        return v

    def add_seq(self, seq: str, is_ref: bool) -> None:
        k = self.k
        v = self._get_vertex(seq[:k])
        self._increase_counts_backwards(v, seq[: k - 1])
        if is_ref:
            self.source = v
        for i in range(1, len(seq) - k + 1):
            v = self._extend_chain(v, seq[i : i + k], is_ref)
        if is_ref:
            self.sink = v

    # --- pruned view ------------------------------------------------------
    def _edge_passes(self, eid: int) -> bool:
        return (
            self.e_is_ref[eid]
            or self.e_count[eid] >= self.cfg.prune_factor
            or len(self.out_edges[self.e_src[eid]]) == 1
        )

    def has_cycles(self) -> bool:
        """Back-edge detection over the pruned view, all components."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * len(self.kmers)
        for root in range(len(self.kmers)):
            if color[root] != WHITE:
                continue
            color[root] = GRAY
            stack = [(root, iter(self.out_edges[root]))]
            while stack:
                v, edge_iter = stack[-1]
                next_vertex = -1
                for eid in edge_iter:
                    if not self._edge_passes(eid):
                        continue
                    w = self.e_dst[eid]
                    if color[w] == GRAY:
                        return True
                    if color[w] == WHITE:
                        next_vertex = w
                        break
                if next_vertex < 0:
                    color[v] = BLACK
                    stack.pop()
                else:
                    color[next_vertex] = GRAY
                    stack.append((next_vertex, iter(self.out_edges[next_vertex])))
        return False

    # --- path enumeration + scoring ----------------------------------------
    def find_paths(self) -> List[List[int]]:
        paths: List[List[int]] = []
        path: List[int] = []
        on_path: Set[int] = set()

        def dfs(frm: int) -> None:
            path.append(frm)
            on_path.add(frm)
            if frm == self.sink:
                if len(paths) >= MAX_ENUMERATED_PATHS:
                    raise PathExplosionError("assembly path explosion")
                paths.append(list(path))
            else:
                for eid in self.out_edges[frm]:
                    if self._edge_passes(eid):
                        v = self.e_dst[eid]
                        if v not in on_path:
                            dfs(v)
            path.pop()
            on_path.discard(frm)

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, len(self.kmers) + 1000))
        try:
            dfs(self.source)
        finally:
            sys.setrecursionlimit(old_limit)
        return paths

    def _edge_between(self, u: int, v: int) -> int:
        for eid in self.out_edges[u]:
            if self.e_dst[eid] == v:
                return eid
        raise KeyError((u, v))

    def haplotypes_from_paths(
        self, paths: List[List[int]], window_ref: str
    ) -> List[Haplotype]:
        on_path_edges: Set[int] = set()
        vertices_on_paths: Set[int] = set()
        for path in paths:
            vertices_on_paths.update(path)
            for u, v in zip(path, path[1:]):
                on_path_edges.add(self._edge_between(u, v))

        score: Dict[int, float] = {}
        for v in sorted(vertices_on_paths):
            edges = [eid for eid in self.out_edges[v] if eid in on_path_edges]
            total = float(sum(self.e_count[eid] for eid in edges))
            for eid in edges:
                score[eid] = math.log10(self.e_count[eid] / total)

        haplotypes: List[Haplotype] = []
        for path in paths:
            seq_parts = [self.kmers[path[0]]]
            path_score = 0.0
            for u, v in zip(path, path[1:]):
                seq_parts.append(self.kmers[v][-1])
                path_score += score[self._edge_between(u, v)]
            haplotypes.append(Haplotype("".join(seq_parts), path_score))

        # std::sort by score desc; stable here (ties keep discovery order,
        # which is deterministic — documented deviation from unspecified
        # std::sort tie order).
        haplotypes.sort(key=lambda h: -h.score)
        del haplotypes[self.cfg.max_num_haplotypes :]

        for h in haplotypes:
            offset, cigar = sw_align(
                window_ref, h.bases, self.cfg.sw_params, self.cfg.sw_max_mismatches_all_match
            )
            h.alignment_begin_wrt_ref = offset
            h.cigar = cigar
        return haplotypes


def graph_to_dot(graph: "_Graph") -> str:
    """Graphviz dump mirroring GraphWrapper::print (graph_wrapper.hpp:322-346):
    ref edges red, below-prune-factor edges dotted grey, vertices labeled by
    their k-mer (sources) or last base."""
    lines = ["digraph assembly_graphs {"]
    for eid in range(len(graph.e_src)):
        u, v = graph.e_src[eid], graph.e_dst[eid]
        count = graph.e_count[eid]
        if graph.e_is_ref[eid]:
            style = f"[label={count},color=red];"
        elif count < graph.cfg.prune_factor:
            style = f"[label={count},style=dotted,color=grey];"
        else:
            style = f"[label={count}];"
        lines.append(f"{u} -> {v} {style}")
    for vid, kmer in enumerate(graph.kmers):
        label = kmer if not graph.in_edges[vid] else kmer[-1]
        lines.append(f"{vid} [label={label},shape=box]")
    lines.append("}")
    return "\n".join(lines)


def build_debug_graph(
    reads: Sequence[SAMRecord], ref: str, kmer_size: int, cfg: HCConfig
) -> "_Graph":
    """Build (but don't path-search) the graph for diagnostics dumps."""
    graph = _Graph(kmer_size, cfg)
    segments: List[str] = []
    for read in reads:
        segments.extend(usable_read_segments(read, kmer_size, cfg))
    graph.dup_kmers |= get_dup_kmers(ref, kmer_size)
    for seg in segments:
        graph.dup_kmers |= get_dup_kmers(seg, kmer_size)
    graph.add_seq(ref, True)
    for seg in segments:
        graph.add_seq(seg, False)
    return graph


def get_dup_kmers(seq: str, k: int) -> Set[str]:
    """k-mers occurring more than once within one sequence
    (graph_wrapper.hpp:251-261)."""
    seen: Set[str] = set()
    dups: Set[str] = set()
    for i in range(len(seq) - k + 1):
        kmer = seq[i : i + k]
        if kmer in seen:
            dups.add(kmer)
        else:
            seen.add(kmer)
    return dups


def usable_read_segments(read: SAMRecord, k: int, cfg: HCConfig) -> List[str]:
    """Maximal runs of (base != 'N' and qual >= Q10+33) of length >= k
    (graph_wrapper.hpp:266-286)."""
    seq, qual = read.seq, read.qual
    segments: List[str] = []
    start = -1
    for i in range(len(seq) + 1):
        usable = (
            i < len(seq)
            and seq[i] != "N"
            and ord(qual[i]) >= cfg.min_base_quality_to_use
        )
        if not usable:
            if start >= 0 and i - start >= k:
                segments.append(seq[start:i])
            start = -1
        elif start < 0:
            start = i
    return segments


def assemble_with_kmer(
    reads: Sequence[SAMRecord], ref: str, kmer_size: int, cfg: HCConfig
) -> List[Haplotype]:
    """One attempt at a fixed k (assembler.hpp:21-53). Empty list = rejected."""
    if len(ref) < kmer_size:
        return []
    graph = _Graph(kmer_size, cfg)
    segments: List[str] = []
    for read in reads:
        segments.extend(usable_read_segments(read, kmer_size, cfg))

    graph.dup_kmers |= get_dup_kmers(ref, kmer_size)
    for seg in segments:
        graph.dup_kmers |= get_dup_kmers(seg, kmer_size)
    graph.add_seq(ref, True)
    for seg in segments:
        graph.add_seq(seg, False)

    if len(graph.unique_kmers) > cfg.max_unique_kmers_to_discard:
        return []
    if graph.has_cycles():
        return []
    paths = graph.find_paths()
    return graph.haplotypes_from_paths(paths, ref)


def assemble(
    reads: Sequence[SAMRecord], ref: str, cfg: HCConfig
) -> List[Haplotype]:
    """k-mer retry ladder 25, 35, ... (assembler.hpp:56-68)."""
    kmer_size = cfg.initial_kmer_size
    haplotypes = assemble_with_kmer(reads, ref, kmer_size, cfg)
    iterations = 1
    while not haplotypes and iterations < cfg.max_kmer_iterations:
        iterations += 1
        kmer_size += cfg.kmer_size_iteration_increase
        haplotypes = assemble_with_kmer(reads, ref, kmer_size, cfg)
    return haplotypes

"""3D (k-ary n-cube) torus topology math — APEnet+ §1/§5.

APEnet+ wires nodes into a 3D torus with 6 bidirectional links per node and
routes packets dimension-by-dimension (dimension-ordered routing).  This
module is the pure-Python model of that fabric: coordinates, neighbours,
routes, distances and fault-isolation analysis.  It backs

  * the collective lowering (`core.fabric.lower`) — ring orderings per axis,
  * the serving engine's fabric twin and RDMA endpoint — hop distances,
  * property tests — routing/distance invariants.

Ranks are row-major over ``dims`` (last dim fastest).  A copy of the JAX
package's module of the same name, kept here so the port imports no JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class Torus:
    """A torus with ``dims[i]`` nodes along dimension ``i``."""

    dims: tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.dims or any(d < 1 for d in self.dims):
            raise ValueError(f"invalid torus dims {self.dims!r}")

    # -- coordinates ---------------------------------------------------------
    @property
    def ndims(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def coords(self, rank: int) -> tuple[int, ...]:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for {self.dims}")
        out = []
        for d in reversed(self.dims):
            out.append(rank % d)
            rank //= d
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        if len(coords) != self.ndims:
            raise ValueError("coordinate arity mismatch")
        r = 0
        for c, d in zip(coords, self.dims):
            if not 0 <= c < d:
                raise ValueError(f"coordinate {coords} out of range {self.dims}")
            r = r * d + c
        return r

    def all_ranks(self) -> Iterator[int]:
        return iter(range(self.size))

    # -- links ---------------------------------------------------------------
    def neighbor(self, rank: int, dim: int, step: int) -> int:
        """Neighbour of ``rank`` along ``dim`` at signed offset ``step``."""
        c = list(self.coords(rank))
        c[dim] = (c[dim] + step) % self.dims[dim]
        return self.rank(c)

    def neighbors(self, rank: int) -> list[int]:
        """The (up to) 2*ndims distinct first-hop neighbours (6 for 3D)."""
        out: list[int] = []
        for dim in range(self.ndims):
            if self.dims[dim] == 1:
                continue
            for step in (+1, -1):
                n = self.neighbor(rank, dim, step)
                if n != rank and n not in out:
                    out.append(n)
        return out

    def links(self) -> list[tuple[int, int]]:
        """All undirected links (each once, as (lo, hi))."""
        seen = set()
        for r in self.all_ranks():
            for n in self.neighbors(r):
                seen.add((min(r, n), max(r, n)))
        return sorted(seen)

    # -- distances & routing -------------------------------------------------
    def dim_distance(self, a: int, b: int, dim: int) -> int:
        """Shortest signed-magnitude distance along one torus dimension."""
        d = self.dims[dim]
        delta = abs(self.coords(a)[dim] - self.coords(b)[dim])
        return min(delta, d - delta)

    def dim_step(self, a: int, b: int, dim: int) -> int:
        """Direction (+1/-1/0) of the minimal route along ``dim``."""
        d = self.dims[dim]
        ca, cb = self.coords(a)[dim], self.coords(b)[dim]
        if ca == cb:
            return 0
        fwd = (cb - ca) % d
        return +1 if fwd <= d - fwd else -1

    def hop_distance(self, a: int, b: int) -> int:
        return sum(self.dim_distance(a, b, i) for i in range(self.ndims))

    def route(self, src: int, dst: int) -> list[int]:
        """Dimension-ordered (X then Y then Z) minimal route, inclusive.

        This is exactly the APEnet+ router's static dimension-ordered policy:
        all hops along dim 0 first, then dim 1, then dim 2.
        """
        path = [src]
        cur = src
        for dim in range(self.ndims):
            step = self.dim_step(cur, dst, dim)
            while self.coords(cur)[dim] != self.coords(dst)[dim]:
                cur = self.neighbor(cur, dim, step)
                path.append(cur)
        assert cur == dst
        return path

    @property
    def diameter(self) -> int:
        return sum(d // 2 for d in self.dims)

    @property
    def bisection_links(self) -> int:
        """Links crossing a bisection of the longest dimension (torus: 2 rings
        per orthogonal position)."""
        longest = max(self.dims)
        other = self.size // longest
        wrap = 2 if longest > 2 else 1
        return other * wrap

    # -- ring orderings (for collectives) -------------------------------------
    def ring_perm(self, dim: int, step: int = +1) -> list[tuple[int, int]]:
        """(src, dst) pairs sending one hop along ``dim`` — a ppermute perm."""
        return [(r, self.neighbor(r, dim, step)) for r in self.all_ranks()]

    # -- fault analysis (LO|FA|MO support) ------------------------------------
    def live_components(self, failed: set[int]) -> list[set[int]]:
        """Connected components of the surviving node graph."""
        live = [r for r in self.all_ranks() if r not in failed]
        unvisited = set(live)
        comps: list[set[int]] = []
        while unvisited:
            seed = next(iter(unvisited))
            comp = {seed}
            frontier = [seed]
            while frontier:
                r = frontier.pop()
                for n in self.neighbors(r):
                    if n in unvisited and n not in comp:
                        comp.add(n)
                        frontier.append(n)
            unvisited -= comp
            comps.append(comp)
        return comps

    def is_fault_observable(self, failed_node: int, failed: set[int]) -> bool:
        """A failed node is observable iff >= 1 live first-neighbour survives
        (that neighbour's LO|FA|MO HW raises the alarm — paper §4)."""
        return any(n not in failed for n in self.neighbors(failed_node))

    def all_faults_observable(self, failed: set[int]) -> bool:
        return all(self.is_fault_observable(f, failed) for f in failed)


def enumerate_fault_sets(t: Torus, k: int) -> Iterator[set[int]]:
    """All fault sets of size exactly ``k`` (test helper; small tori only)."""
    for combo in itertools.combinations(range(t.size), k):
        yield set(combo)

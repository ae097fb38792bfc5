"""Hybrid in-memory navigation tier: query-sensitive entry points (port
of `repro.core.nav`).

At pack time ``write_index(nav=True)`` selects ~1-4% of nodes as *pivots*
(seed-stable k-means medoids by default), builds a small Vamana graph
over them, and persists pivot ids + pivot PQ codes + the pivot graph as
an optional ``nav_graph.npz`` sidecar.  At query time a vectorized beam
over that pivot graph — pure ADC against RAM-resident codes, ZERO storage
I/O — drops each query deep into the on-disk graph: the beam's best
pivots replace the fixed ``meta["entry_points"]`` medoid seed.

Pack time stays on the host in numpy, as in the reference
(`select_pivots`, `build_nav` over the port's numpy `vamana.build_vamana`),
so the sidecar a port writes is byte-equal to the reference's. The beam's
bookkeeping (candidate list, visited bitset, stable sort) runs on the host
too; its ADC runs on the search's device, on the LUT stack the search
built there (`core.adc.adc_gather`).

Bit-identity discipline: `nav_seed_batch` is the ONLY implementation of
the nav beam and every operation in it is row-independent (per-query
gathers, per-row sums, per-row stable argsorts), so the scalar oracle
calling it with a batch of one computes the seeds of the vectorized hot
path calling it with the full batch (on the CPU, where the sums run in a
fixed order).  The seed ADC distances are RETURNED (not recomputed by the
callers), so both paths initialize their candidate lists from literally
the same floats.

Compatibility: the sidecar is OPTIONAL.  Dirs without a ``nav`` meta key
load with the tier disabled; a dir whose meta promises nav but whose
sidecar is missing/corrupt/truncated loads WITH A WARNING and nav
disabled — ``CorruptIndexError`` stays reserved for damage to the core
index.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adc import adc_gather
from repro_torch.core.vamana import build_vamana

__all__ = [
    "NAV_SIDECAR", "DEFAULT_FRACTION", "DEFAULT_DEGREE", "DEFAULT_METHOD",
    "NavGraph", "select_pivots", "build_nav", "save_nav", "load_nav",
    "resolve_entry", "nav_seed_batch",
]

#: sidecar filename inside an index directory (format_version >= 3).
NAV_SIDECAR = "nav_graph.npz"

#: pack-time defaults: ~2% pivots (the SPANN-style few-MB tier — well
#: inside AiSAQ's ~10 MB budget), degree-8 k-NN pivot graph, k-means
#: pivot selection.  All recorded in ``meta["nav"]`` by the writer.
DEFAULT_FRACTION = 0.02
DEFAULT_DEGREE = 8
DEFAULT_METHOD = "kmeans"
KMEANS_ITERS = 5
#: k-means runs on at most this many (seeded) sample rows so pivot
#: selection stays O(sample * pivots) at any corpus size.
KMEANS_SAMPLE = 20000

#: query-time beam shape.  Constants (not knobs): the scalar oracle and
#: the batched path must walk the pivot graph identically, and the tier's
#: public knob surface is ``entry=`` alone.
NAV_BEAM_W = 4
NAV_BEAM_L = 8


@dataclass
class NavGraph:
    """The RAM-resident navigation tier of one index.

    All ids in ``pivot_ids`` are STORAGE-space node ids (the writer
    builds the tier after any relabel permutation), so beam output feeds
    the on-disk search directly.  ``graph`` holds pivot-LOCAL indices
    (-1 padded); ``entry_pivots`` are pivot-local beam start indices.
    """

    pivot_ids: np.ndarray      # (P,) int64, storage-space node ids
    codes: np.ndarray          # (P, m) uint8 PQ codes of the pivots
    graph: np.ndarray          # (P, degree) int32 pivot-local knn, -1 pad
    entry_pivots: np.ndarray   # (e,) int32 pivot-local beam entries
    params: dict               # fraction/seed/method/degree/pivots

    def resident_nbytes(self) -> int:
        """RAM the tier pins — charged into ``HostIndex.resident_bytes``
        and therefore against the ``WarmIndexPool`` DRAM budget."""
        return int(self.pivot_ids.nbytes + self.codes.nbytes
                   + self.graph.nbytes + self.entry_pivots.nbytes)


# ---------------------------------------------------------------------------
# pack time: pivot selection + pivot graph
# ---------------------------------------------------------------------------


def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(na, nb) squared L2 via the quadratic form (no (na, nb, d) blowup)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return np.maximum(d, 0.0)


def select_pivots(vectors: np.ndarray, fraction: float = DEFAULT_FRACTION,
                  seed: int = 0, method: str = DEFAULT_METHOD) -> np.ndarray:
    """Seed-stable pivot selection: sorted unique node ids, ~fraction*n
    of them.  ``method="kmeans"`` (default) runs a few seeded k-means
    iterations on a bounded sample and snaps each centroid to its nearest
    actual node (a medoid per region — coverage-driven); ``"random"`` is
    the seeded uniform baseline.  Deterministic in (vectors, fraction,
    seed, method)."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    n = v.shape[0]
    p = max(1, min(n, int(round(n * float(fraction)))))
    rng = np.random.default_rng(seed)
    if method == "random":
        ids = rng.choice(n, size=p, replace=False)
        return np.sort(ids.astype(np.int64))
    if method != "kmeans":
        raise ValueError(f"unknown pivot-selection method {method!r} "
                         "(expected 'kmeans' or 'random')")
    if n <= KMEANS_SAMPLE:
        sample_ids = np.arange(n, dtype=np.int64)
    else:
        sample_ids = np.sort(rng.choice(n, KMEANS_SAMPLE, replace=False)
                             .astype(np.int64))
    s = v[sample_ids]
    centers = s[rng.choice(s.shape[0], size=p, replace=False)].copy()
    for _ in range(KMEANS_ITERS):
        asn = np.argmin(_sq_dists(s, centers), axis=1)
        sums = np.zeros_like(centers, dtype=np.float64)
        np.add.at(sums, asn, s.astype(np.float64))
        cnt = np.bincount(asn, minlength=p).astype(np.float64)
        nonempty = cnt > 0
        centers[nonempty] = (sums[nonempty]
                             / cnt[nonempty, None]).astype(np.float32)
    ids = np.unique(sample_ids[np.argmin(_sq_dists(centers, s), axis=1)])
    if ids.size < p:
        # centroid collisions: top up with seeded picks outside the set
        free = np.ones(n, bool)
        free[ids] = False
        pool = np.flatnonzero(free)
        extra = pool[rng.choice(pool.size, size=p - ids.size, replace=False)]
        ids = np.concatenate([ids, extra.astype(np.int64)])
    return np.sort(ids.astype(np.int64))


def _pivot_medoid(pv: np.ndarray, metric: str) -> int:
    mean = pv.mean(axis=0)
    if metric == "mips":
        return int(np.argmax(pv @ mean))
    return int(np.argmin(((pv - mean) ** 2).sum(axis=1)))


def build_nav(vectors: np.ndarray, codes: np.ndarray, *,
              fraction: float = DEFAULT_FRACTION,
              degree: int = DEFAULT_DEGREE, seed: int = 0,
              method: str = DEFAULT_METHOD,
              metric: str = "l2") -> NavGraph:
    """Build the tier from pack-time arrays (AFTER any relabel
    permutation: ``vectors``/``codes`` must already be in storage
    order, so pivot ids land in storage space)."""
    pivot_ids = select_pivots(vectors, fraction, seed, method)
    pv = np.ascontiguousarray(vectors[pivot_ids], dtype=np.float32)
    P = pivot_ids.size
    degree = max(1, int(degree))
    graph = np.full((P, degree), -1, np.int32)
    if 1 < P <= degree + 1:
        # tiny tier: fully connected (the beam sees everything in 1 hop)
        idx = np.arange(P)
        full = np.tile(idx, (P, 1))
        graph[:, :P - 1] = full[full != idx[:, None]] \
            .reshape(P, P - 1).astype(np.int32)
    elif P > 1:
        # a NAVIGABLE graph, not a plain k-NN graph: pure k-NN over
        # clustered data fragments into per-cluster components and the
        # beam gets trapped in the entry pivot's component.  Vamana's
        # robust pruning keeps long-range edges (alpha > 1), and the
        # pivot set is small so the build is cheap.
        g = build_vamana(pv, R=degree, L=max(2 * degree, 16), alpha=1.2,
                         metric=metric, seed=seed)
        graph[:, :g.shape[1]] = g.astype(np.int32)
    entry = np.array([_pivot_medoid(pv, metric)], np.int32)
    params = dict(pivots=int(P), degree=int(degree),
                  fraction=float(fraction), seed=int(seed), method=method)
    return NavGraph(pivot_ids=pivot_ids,
                    codes=np.ascontiguousarray(codes[pivot_ids],
                                               dtype=np.uint8),
                    graph=graph, entry_pivots=entry, params=params)


def save_nav(path: str, nav: NavGraph):
    """Write the sidecar (fsynced).  Callers write into the index's tmp
    sibling before atomic publication, so no rename dance is needed
    here — crash-safety rides on `write_index`'s whole-dir recipe."""
    with open(path, "wb") as f:
        np.savez(f, pivot_ids=nav.pivot_ids.astype(np.int64),
                 codes=nav.codes.astype(np.uint8),
                 graph=nav.graph.astype(np.int32),
                 entry_pivots=nav.entry_pivots.astype(np.int32))
        f.flush()
        os.fsync(f.fileno())


def load_nav(path: str, meta: dict) -> Optional[NavGraph]:
    """Tolerant sidecar loader: the nav tier is an ACCELERATOR, never a
    correctness dependency.  Returns None (tier disabled) when the dir
    has no nav (v1/v2 dirs: no ``nav`` meta key), and WARNS + returns
    None when meta promises nav but the sidecar is missing, truncated,
    corrupt, or inconsistent with the core index.  Never raises:
    ``CorruptIndexError`` is reserved for core-index damage."""
    info = meta.get("nav")
    if not isinstance(info, dict):
        return None
    fpath = os.path.join(path, NAV_SIDECAR)

    def _disabled(why: str) -> None:
        warnings.warn(
            f"{path!r}: navigation sidecar unusable ({why}); serving "
            "with nav disabled (entry='auto' falls back to medoid "
            "seeding)", RuntimeWarning, stacklevel=2)
        return None

    try:
        with np.load(fpath) as z:
            pivot_ids = np.asarray(z["pivot_ids"], dtype=np.int64)
            codes = np.asarray(z["codes"], dtype=np.uint8)
            graph = np.asarray(z["graph"], dtype=np.int32)
            entry = np.asarray(z["entry_pivots"], dtype=np.int32)
    except Exception as e:  # noqa: BLE001 — any unreadable sidecar
        return _disabled(f"{type(e).__name__}: {e}")
    P = pivot_ids.shape[0]
    n = int(meta["n"])
    m = int(meta["pq_m"])
    if pivot_ids.ndim != 1 or P == 0:
        return _disabled(f"pivot_ids shape {pivot_ids.shape}")
    if pivot_ids.min() < 0 or pivot_ids.max() >= n:
        return _disabled(f"pivot ids outside [0, {n})")
    if codes.shape != (P, m):
        return _disabled(f"codes shape {codes.shape} != ({P}, {m})")
    if graph.ndim != 2 or graph.shape[0] != P or graph.max(initial=-1) >= P:
        return _disabled(f"pivot graph shape {graph.shape} inconsistent "
                         f"with {P} pivots")
    if entry.ndim != 1 or entry.size == 0 or entry.min() < 0 \
            or entry.max() >= P:
        return _disabled(f"entry_pivots {entry!r} outside [0, {P})")
    if int(info.get("pivots", P)) != P:
        return _disabled(f"meta promises {info.get('pivots')} pivots, "
                         f"sidecar holds {P}")
    return NavGraph(pivot_ids=pivot_ids, codes=codes, graph=graph,
                    entry_pivots=entry, params=dict(info))


# ---------------------------------------------------------------------------
# query time: entry resolution + the vectorized in-RAM nav beam
# ---------------------------------------------------------------------------


def resolve_entry(host, entry: str) -> str:
    """``"auto"`` -> ``"nav"`` iff the index carries a loaded tier, else
    ``"medoid"``; explicit ``"nav"`` on a nav-less index is a usage
    error (ValueError), while ``"medoid"`` always works."""
    if entry not in ("auto", "nav", "medoid"):
        raise ValueError(f"entry must be 'auto', 'nav' or 'medoid', "
                         f"got {entry!r}")
    nav = getattr(host, "nav", None)
    if entry == "auto":
        return "nav" if nav is not None else "medoid"
    if entry == "nav" and nav is None:
        raise ValueError(
            "entry='nav' requested but this index has no navigation tier "
            "(built without nav, or its sidecar failed to load — see the "
            "load warning); use entry='auto' to fall back silently")
    return entry


def _group_rank(group_ids: np.ndarray) -> np.ndarray:
    """Rank within consecutive groups (core.traversal's helper, local
    copy: traversal imports this module, so the edge must point here)."""
    if group_ids.size == 0:
        return group_ids
    starts = np.flatnonzero(
        np.concatenate([[True], group_ids[1:] != group_ids[:-1]]))
    return np.arange(group_ids.size) - np.repeat(
        starts, np.diff(np.concatenate([starts, [group_ids.size]])))


def nav_seed_batch(nav: NavGraph, lut_g: torch.Tensor,
                   dq: Optional[torch.Tensor], n_seeds: int
                   ) -> Tuple[np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """The in-RAM nav beam: per-query entry vertices for the on-disk
    search.  Pure ADC against the RAM-resident pivot codes — zero
    storage I/O.

    ``lut_g`` is the caller's per-query LUT stack on the search's device —
    (nq, m, ks) f32, or int8 with ``dq`` = (nq, m) f32 dequant factors
    (``host_lut_int8`` scale * float32(1/127)), EXACTLY as `core.traversal`
    scores neighbor codes — so beam distances live in the same
    quantization regime as the main search.  Each hop's fresh pivot codes
    go to that device and their distances come back (`adc_gather`); the
    bookkeeping stays on the host.  Every operation is row-independent: a
    batch of one computes the output rows of the full batch.

    Returns ``(seed_ids (nq, s) int64 STORAGE-space (-1 padded),
    seed_d (nq, s) f32 ADC dists (+inf on padding), hops (nq,),
    adc_evals (nq,))`` as numpy arrays; rows are sorted best-first, so
    ``seed_d[:, 0]`` is the per-query entry distance.
    """
    dev = lut_g.device
    nq = lut_g.shape[0]
    P = nav.pivot_ids.shape[0]
    eps = nav.entry_pivots.astype(np.int64)
    e = eps.size
    n_seeds = max(1, int(n_seeds))
    beam_L = max(NAV_BEAM_L, n_seeds, e)
    width = max(beam_L, e)

    def dists(qi: np.ndarray, pivots: np.ndarray) -> np.ndarray:
        return adc_gather(lut_g, dq, torch.from_numpy(qi).to(dev),
                          torch.from_numpy(nav.codes[pivots]).to(dev)
                          ).cpu().numpy()

    cand_i = np.full((nq, width), -1, np.int64)
    cand_d = np.full((nq, width), np.inf, np.float32)
    cand_exp = np.ones((nq, width), bool)
    e_q = np.repeat(np.arange(nq), e)
    cand_d[:, :e] = dists(e_q, np.tile(eps, nq)).reshape(nq, e)
    cand_i[:, :e] = eps
    cand_exp[:, :e] = False
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :beam_L]
    cand_i = np.take_along_axis(cand_i, order, 1)
    cand_d = np.take_along_axis(cand_d, order, 1)
    cand_exp = np.take_along_axis(cand_exp, order, 1)
    hops = np.zeros(nq, np.int64)
    evals = np.full(nq, e, np.int64)
    bits = np.zeros((nq, -(-P // 64)), np.uint64)
    np.bitwise_or.at(
        bits, (np.repeat(np.arange(nq), e), np.tile(eps >> 6, nq)),
        np.tile(np.uint64(1) << (eps & 63).astype(np.uint64), nq))
    R = nav.graph.shape[1]
    while True:
        sel = ~cand_exp & np.isfinite(cand_d)
        fmask = sel & (np.cumsum(sel, axis=1) <= NAV_BEAM_W)
        if not fmask.any():
            break
        qf, cols = np.nonzero(fmask)
        cand_exp |= fmask
        nf = cand_i[qf, cols]
        np.add.at(hops, np.unique(qf), 1)
        nbr = nav.graph[nf].astype(np.int64)                # (F, R)
        q_rep = np.repeat(qf, R)
        ids_f = nbr.reshape(-1)
        valid = ids_f >= 0
        safe = np.where(valid, ids_f, 0)
        seen = (bits[q_rep, safe >> 6] >>
                (safe & 63).astype(np.uint64)) & np.uint64(1)
        first_occ = np.zeros(ids_f.size, bool)
        key = np.where(valid, q_rep * P + safe,
                       nq * P + np.arange(ids_f.size))
        first_occ[np.unique(key, return_index=True)[1]] = True
        fresh = valid & (seen == 0) & first_occ
        f_q = q_rep[fresh]
        f_i = ids_f[fresh]
        if not f_i.size:
            continue
        f_d = dists(f_q, f_i)
        np.add.at(evals, f_q, 1)
        np.bitwise_or.at(bits, (f_q, f_i >> 6),
                         np.uint64(1) << (f_i & 63).astype(np.uint64))
        counts = np.bincount(f_q, minlength=nq)
        K = int(counts.max())
        nrank = _group_rank(f_q)
        new_i = np.full((nq, K), -1, np.int64)
        new_d = np.full((nq, K), np.inf, np.float32)
        new_i[f_q, nrank] = f_i
        new_d[f_q, nrank] = f_d
        all_i = np.concatenate([cand_i, new_i], axis=1)
        all_d = np.concatenate([cand_d, new_d], axis=1)
        all_exp = np.concatenate([cand_exp, ~np.isfinite(new_d)], axis=1)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :beam_L]
        cand_i = np.take_along_axis(all_i, order, 1)
        cand_d = np.take_along_axis(all_d, order, 1)
        cand_exp = np.take_along_axis(all_exp, order, 1)
    s = min(n_seeds, cand_i.shape[1])
    out_i = cand_i[:, :s]
    out_d = cand_d[:, :s].copy()
    pad = ~np.isfinite(out_d)
    seed_ids = np.where(pad, np.int64(-1),
                        nav.pivot_ids[np.where(out_i >= 0, out_i, 0)])
    out_d[pad] = np.inf
    return seed_ids.astype(np.int64), out_d.astype(np.float32), hops, evals

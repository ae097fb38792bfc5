"""`kernels.segment.prepare_csr`'s summation plan against a numpy
construction of the same rules, on the CPU.

- The forward's hot sources: the top HOT_MAX sources by the entries that
  read them, ties to the lower id, each read by at least HOT_MIN_EDGES
  entries and together at least HOT_MIN_SHARE of them, else none; `col`
  keeps the true ids and `hot_col` codes a hot one -2^31 + rank * 2^22 +
  id. None on molecule's batched graphs at the real constants, nor on a
  graph of more than 2^22 sources.
- The backward's hub rows (more than CHUNK entries) sorted stably by
  destination; every other row, and every row of the forward, in the
  edge list's order.
- Chunks: a hub row's entries cut where the destination band (BAND_ROWS
  rows) changes and every CHUNK entries within a band; they cover every
  hub entry once and none crosses a band; the table runs band-major; the
  hub pass adds a hub's partials in slot order, which is destination
  order.
- The plan's float32 passes (rows, chunks, slots), run in numpy, give the
  float64 sums within the running-error bound of their order.

CHUNK and BAND_ROWS are monkeypatched small so that the CPU builds hubs
and bands; the kernel itself runs on the card (`chip_smoke.py`'s
`[gnn_parity]` and `[gnn_serve]` hold it bit for bit to this order).
"""
import numpy as np
import pytest
import torch

from repro_torch.data import pipeline
from repro_torch.kernels import segment
from repro_torch.models.gnn import batched_csr


def np_plan(rows, cols, n_rows, n_cols, chunk, band_rows, hot):
    """The CSR and its plan by the rules, in numpy and Python loops."""
    counts = np.bincount(rows, minlength=n_rows)
    order = np.argsort(rows, kind="stable")
    col = cols[order].copy()
    indptr = np.concatenate([[0], np.cumsum(counts)])
    hubs = np.flatnonzero(counts > chunk)

    def band(c):
        return c // band_rows if band_rows else 0
    if band_rows:
        for h in hubs:
            seg = col[indptr[h]:indptr[h + 1]]
            col[indptr[h]:indptr[h + 1]] = seg[np.argsort(seg, kind="stable")]
    slots = []                                  # (row, beg, end, band)
    first = [0]
    for h in hubs:
        p, e = indptr[h], indptr[h + 1]
        while p < e:
            q = p
            while q < e and band(col[q]) == band(col[p]):
                q += 1
            slots += [(h, s, min(s + chunk, q), band(col[p]))
                      for s in range(p, q, chunk)]
            p = q
        first.append(len(slots))
    table = sorted(range(len(slots)), key=lambda k: (slots[k][3], k))
    hot_ids = np.zeros(0, np.int64)
    if hot:
        cc = np.bincount(cols, minlength=n_cols)
        ranked = sorted(range(n_cols), key=lambda i: (-cc[i], i))
        top = [i for i in ranked[:segment.HOT_MAX]
               if cc[i] >= segment.HOT_MIN_EDGES]
        if cc[top].sum() >= segment.HOT_MIN_SHARE * len(cols):
            hot_ids = np.array(top, np.int64)
    rank = {int(s): i for i, s in enumerate(hot_ids)}
    hot_col = np.array([-2 ** 31 + rank[c] * 2 ** 22 + c if c in rank else c
                        for c in col], np.int64)
    return dict(indptr=indptr, col=col, hub_rows=hubs,
                hub_first=np.array(first),
                chunk_row=np.array([slots[k][0] for k in table], np.int64),
                chunk_beg=np.array([slots[k][1] for k in table], np.int64),
                chunk_end=np.array([slots[k][2] for k in table], np.int64),
                chunk_slot=np.array(table, np.int64), hot_ids=hot_ids,
                hot_col=hot_col, bands=[slots[k][3] for k in table])


def _check(csr, want):
    for k in ("indptr", "col", "hub_rows", "hub_first", "chunk_row",
              "chunk_beg", "chunk_end", "chunk_slot", "hot_ids", "hot_col"):
        np.testing.assert_array_equal(getattr(csr, k).numpy(), want[k],
                                      err_msg=k)


def plan_sum(x, csr):
    """The kernel's passes in float32 numpy, in the plan's order: rows of
    at most CHUNK entries, each chunk into its slot, each hub's slots."""
    ip, col = csr.indptr.numpy(), csr.col.numpy()
    out = np.zeros((csr.n_rows, x.shape[1]), np.float32)

    def run(beg, end):
        acc = np.zeros(x.shape[1], np.float32)
        for e in range(beg, end):
            acc = acc + x[col[e]]
        return acc
    for r in range(csr.n_rows):
        if ip[r + 1] - ip[r] <= segment.CHUNK:
            out[r] = run(ip[r], ip[r + 1])
    part = np.zeros((csr.n_chunks, x.shape[1]), np.float32)
    for k in range(csr.n_chunks):
        part[int(csr.chunk_slot[k])] = run(int(csr.chunk_beg[k]),
                                           int(csr.chunk_end[k]))
    first = csr.hub_first.numpy()
    for h, row in enumerate(csr.hub_rows.numpy()):
        acc = np.zeros(x.shape[1], np.float32)
        for s in range(first[h], first[h + 1]):
            acc = acc + part[s]
        out[row] = acc
    return out


CASES = [(8, 64, 300, 0), (8, 32, 300, 1), (16, 100, 500, 2),
         (4, 7, 200, 3), (32, 10_000, 400, 4)]


@pytest.fixture(params=CASES, ids=[f"chunk{c}-band{b}-n{n}-seed{s}"
                                   for c, b, n, s in CASES])
def small_plan(request, monkeypatch):
    chunk, band, n, seed = request.param
    monkeypatch.setattr(segment, "CHUNK", chunk)
    monkeypatch.setattr(segment, "BAND_ROWS", band)
    monkeypatch.setattr(segment, "HOT_MIN_EDGES", 4)
    g = pipeline.make_graph(n, 6, 5, 4, seed=seed)
    e = g["edges"].astype(np.int64)
    csr = segment.prepare_csr(torch.from_numpy(g["edges"]), n, device="cpu")
    return csr, e, n, chunk, band, g["feats"]


def test_destination_csr_keeps_edge_order_and_stages_hot_sources(
        small_plan):
    csr, e, n, chunk, _, _ = small_plan
    want = np_plan(e[:, 1], e[:, 0], n, n, chunk, 0, hot=True)
    _check(csr.by_dst, want)
    assert csr.by_dst.band_rows == 0
    assert csr.by_dst.n_hot > 0
    # the true ids stay in `col`; a hot entry's code holds its id and rank
    hot = csr.by_dst.hot_col.numpy().astype(np.int64)
    ids = csr.by_dst.hot_ids.numpy()
    col = csr.by_dst.col.numpy()
    rank = (hot + 2 ** 31) >> segment.HOT_ID_BITS
    np.testing.assert_array_equal(
        np.where(hot < 0, (hot + 2 ** 31) % 2 ** segment.HOT_ID_BITS, hot),
        col)
    np.testing.assert_array_equal(ids[rank[hot < 0]], col[hot < 0])


def test_source_csr_sorts_hub_rows_by_destination_in_bands(small_plan):
    csr, e, n, chunk, band, _ = small_plan
    want = np_plan(e[:, 0], e[:, 1], n, n, chunk, band, hot=False)
    _check(csr.by_src, want)
    b = csr.by_src
    assert b.band_rows == band and b.n_hot == 0
    assert b.hub_rows.numel() > 0
    ip, col = b.indptr.numpy(), b.col.numpy()
    for h in b.hub_rows.numpy():
        # a permutation of the row's edges, sorted stably by destination
        mine = e[e[:, 0] == h, 1]
        np.testing.assert_array_equal(col[ip[h]:ip[h + 1]],
                                      mine[np.argsort(mine, kind="stable")])


def test_chunks_cover_hub_entries_once_within_bands(small_plan):
    csr, _, _, chunk, band, _ = small_plan
    b = csr.by_src
    ip, col = b.indptr.numpy(), b.col.numpy()
    beg, end = b.chunk_beg.numpy(), b.chunk_end.numpy()
    row = b.chunk_row.numpy()
    cover = np.zeros(col.shape[0], np.int64)
    for k in range(b.n_chunks):
        assert 0 < end[k] - beg[k] <= chunk
        assert ip[row[k]] <= beg[k] and end[k] <= ip[row[k] + 1]
        cover[beg[k]:end[k]] += 1
        bands = col[beg[k]:end[k]] // band
        assert (bands == bands[0]).all()
    hub = np.zeros(col.shape[0], bool)
    for h in b.hub_rows.numpy():
        hub[ip[h]:ip[h + 1]] = True
    np.testing.assert_array_equal(cover, hub.astype(np.int64))
    # band-major: the bands of the table never go back
    tb = col[beg] // band
    assert (np.diff(tb) >= 0).all()
    if band < len(ip):
        assert len(set(tb)) > 1


def test_hub_pass_adds_partials_in_destination_order(small_plan):
    csr, *_ = small_plan
    for c in (csr.by_dst, csr.by_src):
        slot = c.chunk_slot.numpy()
        by_slot = np.argsort(slot)
        assert sorted(slot) == list(range(c.n_chunks))
        beg = c.chunk_beg.numpy()[by_slot]
        row = c.chunk_row.numpy()[by_slot]
        first = c.hub_first.numpy()
        for h, r in enumerate(c.hub_rows.numpy()):
            s = slice(first[h], first[h + 1])
            assert (row[s] == r).all()
            # slots of a hub in entry order: its destinations ascend
            assert (np.diff(beg[s]) > 0).all()
            dst = c.col.numpy()[beg[s]]
            if c.band_rows:
                assert (np.diff(dst) >= 0).all()


def test_plan_sums_within_the_running_error_bound(small_plan):
    csr, _, n, _, _, feats = small_plan
    x = feats.astype(np.float32)
    for c in (csr.by_dst, csr.by_src):
        got = plan_sum(x, c).astype(np.float64)
        want = np.zeros((n, x.shape[1]))
        absum = np.zeros((n, x.shape[1]))
        np.add.at(want, c.rows().numpy(), x[c.col.numpy()].astype(
            np.float64))
        np.add.at(absum, c.rows().numpy(), np.abs(x[c.col.numpy()]))
        # each add rounds at most u * |partial| <= u * sum of |terms|
        deg = np.diff(c.indptr.numpy())[:, None]
        lim = 2.0 ** -24 * absum * (deg + c.n_chunks) * 1.001
        assert (np.abs(got - want) <= lim + 1e-30).all()


def test_the_batched_graphs_stage_nothing_and_the_small_ones_have_no_hubs():
    """At the real constants: molecule's batch of 128 graphs stages no
    source and has no hub; graphsage-reddit's full_graph_sm draw has no
    hub either way (its zipf source 1 may be staged)."""
    from repro_torch.configs import get_arch
    arch = get_arch("graphsage-reddit")
    s = arch.shape("full_graph_sm")
    g = pipeline.make_graph(s.n_nodes, max(2, s.n_edges // s.n_nodes), 8,
                            arch.model.n_classes)
    csr = segment.prepare_csr(torch.from_numpy(g["edges"]), s.n_nodes,
                              device="cpu")
    rng = np.random.default_rng(0)
    m = arch.shape("molecule")
    mol = batched_csr(torch.from_numpy(rng.integers(
        0, m.n_nodes, (m.batch_graphs, m.n_edges, 2)).astype(np.int32)),
        m.n_nodes)
    assert mol.by_dst.n_hot == 0 and mol.by_dst.hot_col is mol.by_dst.col
    for c in (csr, mol):
        assert c.by_src.n_hot == 0
        assert c.by_src.n_chunks == 0 and c.by_dst.n_chunks == 0
    assert csr.by_dst.n_hot <= 4


def test_hot_sources_need_their_share(monkeypatch):
    """Uniform sources: no source reaches the share, so none is staged,
    whatever HOT_MIN_EDGES allows."""
    monkeypatch.setattr(segment, "HOT_MIN_EDGES", 1)
    monkeypatch.setattr(segment, "HOT_MAX", 4)
    rng = np.random.default_rng(1)
    e = rng.integers(0, 400, (4000, 2)).astype(np.int32)
    csr = segment.prepare_csr(torch.from_numpy(e), 400, device="cpu")
    assert csr.by_dst.n_hot == 0
    monkeypatch.setattr(segment, "HOT_MIN_SHARE", 0.0)
    csr = segment.prepare_csr(torch.from_numpy(e), 400, device="cpu")
    want = np_plan(e[:, 1].astype(np.int64), e[:, 0].astype(np.int64), 400,
                   400, segment.CHUNK, 0, hot=True)
    assert csr.by_dst.n_hot == 4
    _check(csr.by_dst, want)


def test_no_hot_sources_past_the_code_s_id_bits(monkeypatch):
    """A graph of more sources than the code's id bits hold stages none."""
    monkeypatch.setattr(segment, "HOT_MIN_EDGES", 4)
    g = pipeline.make_graph(300, 6, 5, 4, seed=0)
    csr = segment.prepare_csr(torch.from_numpy(g["edges"]), 300,
                              device="cpu")
    assert csr.by_dst.n_hot > 0
    monkeypatch.setattr(segment, "HOT_ID_BITS", 8)
    csr = segment.prepare_csr(torch.from_numpy(g["edges"]), 300,
                              device="cpu")
    assert csr.by_dst.n_hot == 0 and csr.by_dst.hot_col is csr.by_dst.col


def test_meta_graph_has_no_hot_sources_and_no_bands():
    csr = segment.prepare_csr(torch.zeros((10, 2), dtype=torch.int32,
                                          device="meta"), 5)
    for c in (csr.by_dst, csr.by_src):
        assert c.n_hot == 0 and c.band_rows == 0 and c.n_chunks == 0
        assert c.hot_col.is_meta and c.chunk_end.shape == (0,)

"""The port's navigation tier (`repro_torch.core.nav`) against the
reference's `repro.core.nav`: pack time (pivots, pivot graph, sidecar)
equal to the reference's array for array, the nav beam's seeds within the
ADC tolerance of the reference's (1e-5 relative) and row-independent, the
sidecar loader's degradation on damage, and the entry-mode rules."""
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import index_io as jio
from repro.core import nav as jnav
from repro_torch.core import adc as tadc
from repro_torch.core import index_io as tio
from repro_torch.core import nav as tnav


@pytest.fixture(scope="module")
def nav_dir(tmp_path_factory, small_corpus, built_graph, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    p = str(tmp_path_factory.mktemp("tnav") / "nav")
    jio.write_index(p, vectors=base, graph=built_graph, centroids=cents,
                    codes=codes, metric="l2", mode="aisaq", nav=True,
                    nav_fraction=0.03)
    return p


@pytest.mark.parametrize("method", ["kmeans", "random"])
@pytest.mark.parametrize("fraction", [0.003, 0.02])
def test_build_nav_equals_reference(small_corpus, pq_artifacts, method,
                                    fraction):
    base, _, _ = small_corpus
    _, codes = pq_artifacts
    want = jnav.build_nav(base, codes, fraction=fraction, seed=3,
                          method=method)
    got = tnav.build_nav(base, codes, fraction=fraction, seed=3,
                         method=method)
    for f in ("pivot_ids", "codes", "graph", "entry_pivots"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.params == want.params
    assert got.resident_nbytes() == want.resident_nbytes()


@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
def test_nav_seed_batch_matches_reference(nav_dir, small_corpus, adc_dtype):
    """Seeds, hops and evaluations equal; seed distances within 1e-5."""
    _, q, _ = small_corpus
    j = jio.HostIndex.load(nav_dir)
    t = tio.HostIndex.load(nav_dir, device="cpu")
    try:
        lut = jadc.np_build_lut_batch(j.centroids, q, "l2")
        tlut = tadc.build_lut_batch(t.centroids_t, torch.from_numpy(q), "l2")
        if adc_dtype == "int8":
            q8, s = jadc.np_host_lut_int8(lut)
            want = jnav.nav_seed_batch(j.nav, q8, s * np.float32(1 / 127), 4)
            tq8, ts = tadc.host_lut_int8(tlut)
            got = tnav.nav_seed_batch(t.nav, tq8, ts * float(1 / 127), 4)
        else:
            want = jnav.nav_seed_batch(j.nav, lut, None, 4)
            got = tnav.nav_seed_batch(t.nav, tlut, None, 4)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    finally:
        j.close(), t.close()


def test_nav_seed_batch_row_independent(nav_dir, small_corpus):
    """A batch of one gives the rows of the full batch bit for bit."""
    _, q, _ = small_corpus
    t = tio.HostIndex.load(nav_dir, device="cpu")
    try:
        lut = tadc.build_lut_batch(t.centroids_t, torch.from_numpy(q), "l2")
        full = tnav.nav_seed_batch(t.nav, lut, None, 4)
        for i in range(len(q)):
            one = tnav.nav_seed_batch(t.nav, lut[i:i + 1], None, 4)
            for a, b in zip(one, full):
                np.testing.assert_array_equal(a[0], b[i])
        assert np.isin(full[0][full[0] >= 0], t.nav.pivot_ids).all()
    finally:
        t.close()


@pytest.mark.parametrize("damage", ["missing", "truncated", "garbage",
                                    "bad_ids", "meta_mismatch"])
def test_sidecar_damage_degrades_not_fails(nav_dir, tmp_path, damage):
    p = str(tmp_path / "dmg")
    shutil.copytree(nav_dir, p)
    side = os.path.join(p, tnav.NAV_SIDECAR)
    if damage == "missing":
        os.remove(side)
    elif damage == "truncated":
        blob = open(side, "rb").read()
        open(side, "wb").write(blob[:len(blob) // 2])
    elif damage == "garbage":
        open(side, "wb").write(b"\x00" * 128)
    elif damage == "bad_ids":
        with np.load(side) as z:
            arrs = dict(z)
        arrs["pivot_ids"] = arrs["pivot_ids"] + 10 ** 9
        with open(side, "wb") as f:
            np.savez(f, **arrs)
    else:
        mp = os.path.join(p, "meta.json")
        meta = json.load(open(mp))
        meta["nav"]["pivots"] += 1
        json.dump(meta, open(mp, "w"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        idx = tio.HostIndex.load(p, device="cpu")
    try:
        assert idx.nav is None
        assert any("navigation sidecar unusable" in str(w.message)
                   for w in caught)
        assert tnav.resolve_entry(idx, "auto") == "medoid"
        with pytest.raises(ValueError, match="no navigation tier"):
            idx.search(np.zeros(idx.layout.dim, np.float32), 5, L=16,
                       entry="nav")
    finally:
        idx.close()


def test_entry_rules(index_dirs, nav_dir):
    plain = tio.HostIndex.load(index_dirs["aisaq"], device="cpu")
    nav = tio.HostIndex.load(nav_dir, device="cpu")
    try:
        assert tnav.resolve_entry(plain, "auto") == "medoid"
        assert tnav.resolve_entry(nav, "auto") == "nav"
        assert tnav.resolve_entry(nav, "medoid") == "medoid"
        with pytest.raises(ValueError, match="entry must be"):
            tnav.resolve_entry(nav, "best")
        with pytest.raises(ValueError, match="no navigation tier"):
            tnav.resolve_entry(plain, "nav")
    finally:
        plain.close(), nav.close()

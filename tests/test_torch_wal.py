"""The port's write-ahead journal (`repro_torch.core.wal`) on the cases of
the reference's tests/test_wal.py, plus the cross-checks with
`repro.core.wal`: the frames one package appends are byte-equal to the
other's for the same records, and each package scans the journals the
other wrote (whole, torn and bit-flipped) into the same records.
Tolerance: none — bytes and records are compared exactly."""
import os

import numpy as np
import pytest

from repro.core import wal as RW
from repro_torch.core import wal as W
from repro_torch.core.faults import CrashPoint, KillSwitch


def _open(tmp_path, **kw):
    return W.WriteAheadLog(str(tmp_path / "wal.log"), **kw)


def test_roundtrip(tmp_path):
    wal = _open(tmp_path)
    blob = bytes(range(64))
    wal.append(W.T_INSERT_BEGIN, dict(id=7, chosen=[1, 2, 3]), blob)
    wal.append(W.T_INSERT_COMMIT, dict(id=7))
    wal.append(W.T_DELETE, dict(label=3))
    records, end, torn = wal.scan()
    assert [r.rtype for r in records] == \
        [W.T_INSERT_BEGIN, W.T_INSERT_COMMIT, W.T_DELETE]
    assert records[0].header == dict(id=7, chosen=[1, 2, 3])
    assert records[0].blob == blob
    assert records[1].blob == b""
    assert end == wal.size and not torn
    wal.close()


def test_empty_journal(tmp_path):
    wal = _open(tmp_path)
    records, end, torn = wal.scan()
    assert records == [] and end == 0 and not torn
    wal.close()


def test_torn_tail_is_truncated(tmp_path):
    wal = _open(tmp_path)
    wal.append(W.T_INSERT_BEGIN, dict(id=0), b"x" * 32)
    keep = wal.size
    wal.append(W.T_INSERT_COMMIT, dict(id=0))
    os.ftruncate(wal.fd, wal.size - 1)       # chop the CRC's last byte
    records, end, torn = wal.scan()
    assert len(records) == 1 and end == keep and torn
    wal.truncate(end)
    records2, _, torn2 = wal.scan()
    assert len(records2) == 1 and not torn2
    wal.close()


def test_bitrot_stops_scan(tmp_path):
    wal = _open(tmp_path)
    off0 = wal.append(W.T_INSERT_BEGIN, dict(id=0), b"a" * 16)
    wal.append(W.T_INSERT_COMMIT, dict(id=0))
    wal.append(W.T_DELETE, dict(label=9))
    # one flipped blob byte in the FIRST frame: nothing after it counts
    raw = os.pread(wal.fd, wal.size, 0)
    hit = off0 + W._HDR.size + len(b'{"id":0}')
    os.pwrite(wal.fd, bytes([raw[hit] ^ 0xFF]), hit)
    records, end, torn = wal.scan()
    assert records == [] and end == 0 and torn
    wal.close()


def test_garbage_magic_stops_scan(tmp_path):
    wal = _open(tmp_path)
    wal.append(W.T_DELETE, dict(label=1))
    good = wal.size
    os.pwrite(wal.fd, b"\xde\xad\xbe\xef" + b"\x00" * 16, good)
    records, end, torn = wal.scan()
    assert len(records) == 1 and end == good and torn
    wal.close()


def test_append_returns_offsets(tmp_path):
    wal = _open(tmp_path)
    offs = [wal.append(W.T_DELETE, dict(label=i)) for i in range(5)]
    assert offs == sorted(offs) and offs[0] == 0
    records, _, _ = wal.scan()
    assert [r.offset for r in records] == offs
    wal.close()


def test_kill_switch_mid_frame_is_torn(tmp_path):
    ks = KillSwitch()
    wal = _open(tmp_path, kill=ks)
    wal.append(W.T_INSERT_BEGIN, dict(id=1, chosen=[0]), b"z" * 128)
    assert "wal.mid.1" in ks.labels
    mid = ks.labels.index("wal.mid.1") + 1
    wal.close()
    ks2 = KillSwitch(at=mid)
    wal2 = W.WriteAheadLog(str(tmp_path / "wal2.log"), kill=ks2)
    with pytest.raises(CrashPoint):
        wal2.append(W.T_INSERT_BEGIN, dict(id=1, chosen=[0]), b"z" * 128)
    records, end, torn = wal2.scan()
    assert records == [] and end == 0 and torn   # half a frame on disk
    assert wal2.size > 0
    wal2.close()


def test_blob_roundtrip_binary_safety(tmp_path):
    wal = _open(tmp_path)
    blob = np.random.default_rng(3).integers(0, 256, 4096,
                                             dtype=np.uint8).tobytes()
    wal.append(W.T_INSERT_BEGIN, dict(id=2), blob)
    records, _, torn = wal.scan()
    assert records[0].blob == blob and not torn
    wal.close()


def test_scan_property_truncation_and_bitflips(tmp_path):
    """Property (tests/test_wal.py): `scan` over an arbitrarily truncated
    and bit-flipped journal never raises and never yields a frame at or
    past the first damaged byte."""
    pytest.importorskip("hypothesis")
    import tempfile
    from pathlib import Path
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(data=st.data(), n_records=st.integers(1, 6),
           blob_len=st.integers(0, 300))
    def prop(data, n_records, blob_len):
        with tempfile.TemporaryDirectory() as d:
            wal = _open(Path(d))
            bounds = []
            for i in range(n_records):
                blob = (bytes(range(256)) * (blob_len // 256 + 1))[:blob_len]
                wal.append(W.T_INSERT_BEGIN, dict(id=i, chosen=[i, i + 1]),
                           blob)
                bounds.append(wal.size)
            cut = data.draw(st.integers(0, wal.size), label="cut")
            os.ftruncate(wal.fd, cut)
            first_bad = cut
            if cut:
                flips = data.draw(st.lists(st.tuples(
                    st.integers(0, cut - 1), st.integers(0, 7)),
                    max_size=3), label="flips")
                raw = os.pread(wal.fd, cut, 0)
                for pos, bit in flips:
                    os.pwrite(wal.fd, bytes([raw[pos] ^ (1 << bit)]), pos)
                    first_bad = min(first_bad, pos)
            records, end, _ = wal.scan()
            intact = sum(1 for b in bounds if b <= first_bad)
            assert len(records) <= intact
            assert end <= first_bad or intact == len(bounds)
            for _, b in zip(records, bounds):
                assert b <= first_bad
            wal.close()

    prop()


# ---------------------------------------------------------------------------
# cross-checks with the reference's journal
# ---------------------------------------------------------------------------

def _records(seed):
    """A seeded mix of the three record types, with binary blobs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(3, 9))):
        t = int(rng.integers(1, 4))
        if t == W.T_INSERT_BEGIN:
            chosen = [int(x) for x in rng.integers(0, 500, rng.integers(0, 9))]
            out.append((t, dict(id=500 + i, label=900 + i, n_before=500 + i,
                                file_end=4096 * (i + 3), chunk_bytes=200,
                                chosen=chosen),
                        rng.integers(0, 256, 12 + 200 * len(chosen),
                                     dtype=np.uint8).tobytes()))
        elif t == W.T_INSERT_COMMIT:
            out.append((t, dict(id=500 + i, label=900 + i), b""))
        else:
            out.append((t, dict(label=int(rng.integers(0, 1000))), b""))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("killed", [False, True])
def test_frames_byte_equal_to_reference(tmp_path, seed, killed):
    """The same records appended by both packages (with a counting
    KillSwitch the frame goes down in two halves) give the same file and
    the same tick labels."""
    from repro.core.faults import KillSwitch as RKill
    kt, kr = (KillSwitch(), RKill()) if killed else (None, None)
    port = W.WriteAheadLog(str(tmp_path / "port.log"), kill=kt)
    ref = RW.WriteAheadLog(str(tmp_path / "ref.log"), kill=kr)
    for t, h, b in _records(seed):
        assert port.append(t, h, b) == ref.append(t, h, b)
    port.close(), ref.close()
    assert (tmp_path / "port.log").read_bytes() == \
        (tmp_path / "ref.log").read_bytes()
    if killed:
        assert kt.labels == kr.labels


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("damage", ["none", "torn", "bitflip"])
def test_each_package_reads_the_others_journal(tmp_path, writer, damage):
    mods = {"port": W, "ref": RW}
    path = str(tmp_path / "wal.log")
    w = mods[writer].WriteAheadLog(path)
    recs = _records(7)
    for t, h, b in recs:
        w.append(t, h, b)
    size = w.size
    if damage == "torn":
        os.ftruncate(w.fd, size - 3)
    elif damage == "bitflip":
        raw = os.pread(w.fd, size, 0)
        os.pwrite(w.fd, bytes([raw[size // 2] ^ 0x10]), size // 2)
    w.close()
    scans = {}
    for name, mod in mods.items():
        r = mod.WriteAheadLog(path)
        records, end, torn = r.scan()
        scans[name] = ([(x.rtype, x.header, x.blob, x.offset)
                        for x in records], end, torn)
        r.close()
    assert scans["port"] == scans["ref"]
    got, end, torn = scans["port"]
    if damage == "none":
        assert [g[:3] for g in got] == [(t, h, b) for t, h, b in recs]
        assert end == size and not torn
    else:
        assert torn and len(got) < len(recs)

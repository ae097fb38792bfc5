"""The hop's bytes and operations, against a count by hand."""
import pytest

from annbench import harness, roofline


def test_stride_matches_the_ports_layout():
    from repro_torch.core.chunk_layout import ChunkLayout
    for name in ("sift1m.b256", "kilt-e5.open"):
        cfg = harness.load_cell(name)["config"]
        lay = ChunkLayout(mode="aisaq", dim=cfg["dim"],
                          data_dtype=cfg["data_dtype"], R=cfg["R"],
                          pq_m=cfg["pq_m"])
        assert roofline.device_stride(cfg) == lay.device_stride


def test_sift1m_hop_by_hand():
    cfg = harness.load_cell("sift1m.b256")["config"]
    # a row: 512 B vector + 4 B degree + 56 ids * 4 + 56 * 128 codes =
    # 7,908 B, padded to 7,936; its id 4 B; written: exact 4 B, 56 ids and
    # 56 distances 448 B. A query: its 128 x 256 f32 table, 131,072 B, and
    # its 512 B vector.
    assert roofline.device_stride(cfg) == 7936
    w = roofline.hop_work(cfg, lanes=3, query_hops=2)
    assert w["bytes"] == 3 * (7936 + 4 + 4 + 448) + 2 * (131072 + 512)
    assert w["flops"] == 3 * (3 * 128 + 56 * 128)


def test_kilt_hop_by_hand():
    cfg = harness.load_cell("kilt-e5.open")["config"]
    # 4,096 B vector + 4 + 276 ids + 69 * 128 = 8,832 codes = 13,208 B,
    # padded to 13,312; mips: 2 d + 1 operations for the exact distance
    assert roofline.device_stride(cfg) == 13312
    w = roofline.hop_work(cfg, lanes=1, query_hops=1)
    assert w["bytes"] == 13312 + 4 + 4 * (1 + 138) + 131072 + 4096
    assert w["flops"] == 2 * 1024 + 1 + 69 * 128


def test_bound_takes_the_larger_and_knows_its_cards():
    work = {"bytes": 3.35e9, "flops": 1e9}
    assert roofline.bound_s("NVIDIA H100 80GB HBM3", work) == \
        pytest.approx(1e-3)
    assert roofline.bound_s("NVIDIA H100 80GB HBM3",
                            {"bytes": 0, "flops": 67e9}) == pytest.approx(1e-3)
    assert roofline.bound_s("some other card", work) is None

"""Bytes and operations of the hop kernel, and the card's peaks.

The hop's work is counted from what its inputs need, whatever implements
it (the arithmetic of the port's `launch/ann_trace.hop_bytes` and
`hop_charge`, copied): for each live frontier row, the chunk row at the
device stride, its id, and the exact distance, neighbour ids and
neighbour PQ distances written; for each query with a live row in the
hop, its distance table (f32) and its vector. A live row is one the
search expands; padded, finished and past-the-end lanes count nothing.

Operations a live row: the exact distance (3 d for l2: a difference and
an FMA an entry; 2 d + 1 for mips) and R * m table reads added for the
neighbours' PQ distances (the int8 hop adds each row's R rescales and
each query's quantisation of its table, 2 m ks).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def device_stride(cfg: dict) -> int:
    """Bytes of a chunk row on the device (AiSAQ placement): the vector
    padded to 4 B, the degree and R ids, and R * m neighbour codes,
    padded to 128 B."""
    vec = cfg["dim"] * (1 if cfg["data_dtype"] == "uint8" else 4)
    vec = -(-vec // 4) * 4
    raw = vec + 4 * (1 + cfg["R"]) + cfg["R"] * cfg["pq_m"]
    return -(-raw // 128) * 128


def hop_work(cfg: dict, lanes: int, query_hops: int) -> dict:
    """Bytes and operations of the hops that expanded `lanes` frontier
    rows in all, over `query_hops` (query, hop) pairs with a live row."""
    d, R, m, ks = cfg["dim"], cfg["R"], cfg["pq_m"], cfg["pq_ks"]
    per_row = device_stride(cfg) + 4 + 4 * (1 + 2 * R)
    per_query = 4 * m * ks + 4 * d
    exact = 2 * d + 1 if cfg["metric"] == "mips" else 3 * d
    flops = lanes * (exact + R * m)
    if cfg["adc_dtype"] == "int8":
        flops += lanes * R + query_hops * 2 * m * ks
    return {"bytes": lanes * per_row + query_hops * per_query,
            "flops": flops}


def bound_s(kind: str, work: dict) -> float | None:
    """The least time the card `kind` could take for `work`: the larger of
    bytes over peak bandwidth and operations over the float32 peak. None
    for a card the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(work["bytes"] / peak["hbm_bytes_per_s"],
               work["flops"] / peak["f32_flops_per_s"])

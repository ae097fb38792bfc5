"""The benchmark harness: a cell's set-up, its measured window, the traced
window's readings and the comparison that decides `correct`.

A cell is a configuration (`configs/<name>.json`) under a traffic mix
(`traffic/<name>.json`), both found by the names `BENCHMARK.json` gives;
each metric is read by `metrics/<name>.py` (or, for a name with a dotted
suffix such as `device_idle.open`, by `metrics/<part before the dot>.py`).
Nothing here names a cell, a mix or a metric.

The program under test is the port, `repro_torch`: `from_arrays` packs
the index, `make_device_search_fn` serves it, and in an open-loop mix
`ServingEngine` batches the requests. The harness hands them the inputs
it drew and reads back only the ids they return, the kernels' launch
counters and the profiler's device trace.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from annbench import inputs, reference, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the share of the hop launches a profile may lose, and the device numbers
# still be read: on the card a profile of thousands of graph-replayed
# launches has missed 0.2-0.5% of them in some runs, which moves busy time
# and the hop's time by as little
LOST_MAX = 0.01


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules(names) -> list:
    """Names whose top-level package (the part before the first dot) is
    JAX, jaxlib, flax or the JAX package `repro`, compared whole: the
    port `repro_torch` is not `repro`."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# cells, mixes and metrics, by name
# ---------------------------------------------------------------------------


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The workload's configuration and traffic mix, and the end-to-end and
    per-layer metrics `BENCHMARK.json` has it report."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    wl = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]

    def mine(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return {"name": workload, "chips": wl["chips"],
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": load_traffic(wl["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_traffic(name: str) -> dict:
    tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if tr.get("kind") not in ("closed", "open"):
        raise ValueError(f"traffic {name!r}: kind {tr.get('kind')!r} is "
                         "neither 'closed' nor 'open'")
    return tr


def reader(metric: str):
    """The `read(readings) -> float | None` of a metric's own file."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"annbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {metric!r} in {HERE / 'metrics'}")


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------


def replay_traced(fn, pool: np.ndarray, calls: list, k: int,
                  n: int) -> tuple:
    """The last `n` calls of the window made again, back to back, with the
    same requests, under the profiler: the device work of each call is
    the window's, while the tracing library's cost on every graph launch
    (it nearly doubles a call's wall time) stays out of the window.
    Returns (the trace's `trace.Window`, the calls replayed, the hop
    launches the program counted in them)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    pick = calls[-n:]
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t = time.perf_counter()
    prof = profile(activities=acts)
    prof.start()
    before = _hop_launches(_build.launch_counts)
    for _, _, first, b in pick:
        rows = np.arange(first, first + b) % len(pool)
        with torch.profiler.record_function(trace.SPAN):
            fn(pool[rows], k)
    launches = _hop_launches(_build.launch_counts) - before
    prof.stop()
    window = trace.read_window(prof)
    log(f"[trace] replayed={len(pick)} s={time.perf_counter() - t:.3f}")
    return window, pick, launches


def _hop_launches(counts: dict) -> int:
    return sum(v for k, v in counts.items() if k.startswith("fused_hop"))


class Recorder:
    """The search callable the window drives: it checks that each call
    holds the next requests in order (query rows of the pool) and times
    it."""

    def __init__(self, fn, pool: np.ndarray):
        self.fn, self.pool = fn, pool
        self.next = 0
        self.calls = []          # (start, end, first request, size)
        self.misrouted = 0

    def __call__(self, queries: np.ndarray, k: int) -> np.ndarray:
        t = time.perf_counter()
        first, b = self.next, len(queries)
        self.next += b
        rows = np.arange(first, first + b) % len(self.pool)
        if not np.array_equal(queries, self.pool[rows]):
            self.misrouted += 1
            raise RuntimeError("a search call does not hold the next "
                               "requests in order")
        ids = self.fn(queries, k)
        self.calls.append((t, time.perf_counter(), first, b))
        return ids


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


def build_program(cfg: dict, inp: dict, device):
    """The port's index and its served search callable."""
    from repro_torch.core.device_index import from_arrays
    from repro_torch.serving.engine import make_device_search_fn
    index, layout = from_arrays(inp["vectors"], inp["graph"],
                                inp["centroids"], inp["codes"],
                                mode=cfg["mode"],
                                block_bytes=cfg["block_bytes"], device=device)
    fn = make_device_search_fn(index, layout, metric=cfg["metric"],
                               L=cfg["L"], w=cfg["w"],
                               max_hops=cfg["max_hops"],
                               adc_dtype=cfg["adc_dtype"],
                               rerank=cfg["rerank"], device=device)
    return index, layout, fn


def warm_sizes(tr: dict) -> list:
    """The batch sizes set-up sends. Closed loop: its one batch twice (the
    graphs captured, then replayed). Open loop: the program pads a batch
    to the next power of two and captures one set of graphs a padded
    size, so each power of two up to `max_batch` (capped at it) once,
    then `max_batch - 1`, a batch that is padded, as most of the window's
    are."""
    if tr["kind"] == "closed":
        return [tr["batch"]] * 2
    top = tr["max_batch"]
    sizes = sorted({min(1 << i, top) for i in range(top.bit_length() + 1)})
    return sizes[:-1] + [top - 1, top] if top > 2 else sizes


def last_warm_call(fn, queries: np.ndarray, k: int, cuda: bool) -> dict:
    """The last warm-up call, made under the sync debugger on the card:
    its host syncs and the device bytes it held above what was held
    before it, for the log."""
    from repro_torch.core.device_index import HOPS_PER_SYNC
    facts = {"batch": len(queries), "hops_per_sync": HOPS_PER_SYNC}
    if not cuda:
        fn(queries, k)
        return facts
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(queries, k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    facts["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    facts["search_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    facts["peak_before"] = peak
    return facts


def arrivals(tr: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times (s into the window) of an open-loop mix: round(rate *
    seconds) exponential gaps drawn once from the mix's own seed, scaled to
    fill the window, in an order the run's seed shuffles. Every seed sends
    the same requests' worth of gaps; only their order differs. Poisson
    arrivals are the only kind drawn: a mix that asks for another raises."""
    if tr.get("arrival") != "poisson":
        raise ValueError(f"arrival {tr.get('arrival')!r}: the harness draws "
                         "only 'poisson' arrivals")
    n = max(1, round(tr["rate_per_s"] * seconds))
    gaps = np.random.default_rng(tr["gap_seed"]).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(seed % 2**63).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


@dataclass
class Readings:
    """What the metric readers read."""
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float
    window_s: float
    attempted: int
    completed: int
    latencies_s: np.ndarray | None = None
    calls: int = 0
    waits_s: np.ndarray | None = None
    window: trace.Window | None = None
    traced_queries: int = 0
    traced_span_s: float = 0.0
    lanes: int = 0
    query_hops: int = 0


def prepare(cell: dict, seed: int, seconds: float, device) -> dict:
    """Set-up: the inputs drawn from the seed, the program's index packed
    from them, and every shape the mix sends warmed up (on the card: each
    padded batch captured as CUDA graphs)."""
    cfg, tr = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build
        _build.lib()
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    inp = inputs.draw_index(cfg, seed, dev)
    due = None
    if tr["kind"] == "open":
        due = arrivals(tr, seconds, seed)
        n_pool = len(due)
    else:
        n_pool = tr["query_pool"]
    pool_t = inputs.draw_queries(cfg, n_pool, inp["vectors"], seed)
    pool = pool_t.cpu().numpy()
    if cuda:
        torch.cuda.synchronize()
    t_draw = time.perf_counter() - t
    t = time.perf_counter()
    index, layout, fn = build_program(cfg, inp, dev)
    if cuda:
        torch.cuda.synchronize()
    t_pack = time.perf_counter() - t
    t = time.perf_counter()
    sizes = warm_sizes(tr)
    for b in sizes[:-1]:
        fn(pool[:b], cfg["k"])
    facts = last_warm_call(fn, pool[:sizes[-1]], cfg["k"], cuda)
    peak = facts.pop("peak_before", 0)
    if cuda:
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    log(f"[setup] build_s={t_build:.3f} draw_s={t_draw:.3f} "
        f"pack_s={t_pack:.3f} warm_s={time.perf_counter() - t:.3f} "
        f"sizes={len(sizes)} graphs={len(index.graphs)} "
        f"table_bytes={index.chunk_words.numel() * 4}")
    log("[search] " + " ".join(f"{k}={v}" for k, v in facts.items()))
    return {"dev": dev, "cuda": cuda, "inp": inp, "due": due, "pool": pool,
            "pool_t": pool_t, "program": (index, layout, fn), "peak": peak,
            "entry": int(index.ep_ids[0]),
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}


def freeze_heap() -> None:
    """Move every object made so far (the imported libraries, the inputs,
    the program's set-up) out of the cyclic collector's reach, as a
    server does once it has started: a full collection then walks only
    what the window allocates. Without it, collections of the ~170,000
    objects that importing torch leaves stalled the process for up to
    ~100 ms at a time, and the requests due meanwhile with it."""
    gc.collect()
    gc.freeze()


def verdict(checks: dict) -> bool:
    """`correct`: every number compared lies within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def entry_gap(dist: torch.Tensor, row: int) -> float:
    """How much farther from the corpus mean the program's entry row lies
    than the reference's, relative to the reference's, both by the
    reference's float64 distances: 0 where both start from one row;
    float32 rounding where the two broke a near-tie apart (then the
    searches, and nearly every answer, part ways: a tie, not a fault)."""
    best = dist.min()
    return float((dist[row] - best) / best.clamp_min(1e-30))


def answers_differing(port: np.ndarray, ref: np.ndarray) -> float:
    """The share of answers (rows of k ids, in order) that differ from the
    reference's; 1.0 when there is none to compare."""
    if not len(port):
        return 1.0
    return float((port.astype(np.int64) != ref.astype(np.int64))
                 .any(1).mean())


def sample_rows(done: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n of the answered request indices `done`, drawn from the seed."""
    g = inputs.generator(seed, "sample", "cpu")
    return done[torch.randperm(len(done), generator=g)[:n].numpy()]


def run(cell: dict, seed: int, seconds: float, traced: bool, device: str,
        t_start: float) -> dict:
    """One run of the cell: set-up, the window, in a traced run the replay
    of its last calls under the profiler, then the reference's judgement.
    Returns the result line's fields, with `checks` last."""
    cfg, tr = cell["config"], cell["traffic"]
    st = prepare(cell, seed, seconds, device)
    cuda, dev, pool = st["cuda"], st["dev"], st["pool"]
    fn = st["program"][2]
    freeze_heap()
    rec = Recorder(fn, pool)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    if tr["kind"] == "closed":
        res = closed_loop(rec, pool, tr["batch"], cfg["k"], seconds)
    else:
        res = open_loop(rec, pool, st["due"], cfg["k"], tr, seconds)
    log_slices(rec.calls, t0)
    peak = st["peak"]
    if cuda:
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    calls, misrouted = rec.calls, rec.misrouted
    replay = replay_traced(fn, pool, calls, cfg["k"], tr["trace_calls"]) \
        if traced and calls else None
    del rec, fn, st["program"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference: the sampled answers, and the replayed calls' queries
    t = time.perf_counter()
    answers = res["answers"]                    # request index -> ids
    pick = sample_rows(np.array(sorted(answers), dtype=np.int64),
                       tr["sample"], seed)
    replayed = replay[1] if replay else []
    t_idx = np.concatenate([np.arange(f, f + b) for _, _, f, b in replayed]) \
        if replayed else np.zeros(0, np.int64)
    rows = np.concatenate([pick, t_idx]) % len(pool)
    dist = reference.entry_distances(st["inp"]["vectors"])
    ep = int(dist.argmin())
    gap = entry_gap(dist, st["entry"])
    ans = reference.search(st["inp"], st["pool_t"][torch.from_numpy(rows)
                                                   .to(dev)], cfg, ep=ep)
    ref_ids = ans.ids.cpu().numpy()[:len(pick)]
    port = np.stack([answers[i] for i in pick]) if len(pick) \
        else np.zeros((0, cfg["k"]), np.int64)
    differing = answers_differing(port, ref_ids)
    ids_differing = float((port != ref_ids).mean()) if len(pick) else 1.0
    log(f"[reference] queries={len(rows)} sampled={len(pick)} "
        f"traced={len(t_idx)} s={time.perf_counter() - t:.3f} "
        f"hops_max={int(ans.hops.max()) if len(rows) else 0} "
        f"entry={ep} program_entry={st['entry']} "
        f"entry_margin={reference.entry_margin(dist)} "
        f"ids_differing={ids_differing}")
    limits = cfg["check"]
    if st["entry"] != ep and gap <= limits["entry_gap_max"]:
        log("[reference] the two entry rows tie within float32 rounding: "
            "the searches start apart, so their answers differ")

    readings = Readings(
        config=cfg, traffic=tr, device_kind=st["kind"], setup_s=setup_s,
        window_s=res["window_s"], attempted=res["attempted"],
        completed=res["attempted"] - res["failed"],
        latencies_s=res.get("latencies_s"), calls=len(calls))
    if "due_s" in res and calls:
        due = res["due_s"]
        readings.waits_s = np.concatenate(
            [c[0] - due[c[2]:c[2] + c[3]] for c in calls])
    if replay:
        _traced_readings(readings, replay, ans, len(pick))
    metrics = {}
    for spec in cell["per_layer" if traced else "end_to_end"]:
        v = reader(spec["name"])(readings)
        if v is not None:
            metrics[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    checks = {
        "entry_gap": {"value": gap, "limit": limits["entry_gap_max"]},
        "answers_differing": {"value": differing,
                              "limit": limits["answers_differing_max"]},
        "unanswered": {"value": res["failed"], "limit": 0},
        "misrouted_calls": {"value": misrouted, "limit": 0},
    }
    out = {"correct": verdict(checks),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": st["kind"], "count": cell["chips"],
                      "memory_peak_bytes": int(peak)}}
    w = readings.window
    if traced and w is not None:
        out["device"]["busy_s"] = w.busy_s
        out["device"]["window_s"] = readings.traced_span_s
        # the gaps are the profiled replay's, where the tracing library's
        # cost sits inside every graph launch: named so
        out["breakdown"] = {"device_ops": w.top_ops(),
                            "idle_gaps": [["profiled replay: " + g, s]
                                          for g, s in w.idle_gaps()]}
    out["checks"] = checks
    return out


def _traced_readings(r: Readings, replay: tuple, ans: reference.Answers,
                     n_pick: int) -> None:
    w, pick, launches = replay
    r.traced_queries = sum(c[3] for c in pick)
    r.traced_span_s = pick[-1][1] - pick[0][0]
    r.lanes = int(ans.lanes[n_pick:].sum())
    r.query_hops = int(ans.hops[n_pick:].sum())
    seen = w.count(trace.HOP) if w is not None else 0
    log(f"[trace] calls={len(pick)} queries={r.traced_queries} "
        f"span_s={r.traced_span_s} "
        f"replay_window_s={w.window_s if w is not None else 0.0} "
        f"busy_s={w.busy_s if w is not None else 0.0} "
        f"hop_launches_counted={launches} hop_kernels_seen={seen} "
        f"live_lanes={r.lanes} live_query_hops={r.query_hops}")
    if w is not None and w.device and not \
            launches - LOST_MAX * launches <= seen <= launches:
        log(f"[trace] the profile holds {seen} of the {launches} hop "
            f"launches, beyond the {LOST_MAX:.0%} it may lose: no device "
            "metrics")
        w = None
    r.window = w if w is not None and w.device else None


def closed_loop(rec: Recorder, pool: np.ndarray, batch: int, k: int,
                seconds: float) -> dict:
    """Batches of `batch` fresh queries, each sent when the last returns,
    until `seconds` have passed; the window ends when the last call
    returns."""
    answers, failed, n = {}, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rows = np.arange(n, n + batch) % len(pool)
        try:
            ids = rec(pool[rows], k)
            for i in range(batch):
                answers[n + i] = ids[i]
        except Exception as e:      # noqa: BLE001 - a failed call is counted
            log(f"[window] call failed: {e!r}")
            failed += batch
        n += batch
    return {"answers": answers, "attempted": n, "failed": failed,
            "window_s": time.perf_counter() - t0}


def log_slices(calls: list, t0: float) -> None:
    """Requests served in each second of the window, for the log: a rate
    that drifts within a run reads differently from one that differs
    between runs."""
    per = {}
    for start, _, _, b in calls:
        per[int(start - t0)] = per.get(int(start - t0), 0) + b
    log("[window] per_second=" + ",".join(str(per[s]) for s in sorted(per)))


def open_loop(rec: Recorder, pool: np.ndarray, due: np.ndarray, k: int,
              tr: dict, seconds: float) -> dict:
    """One request a question, each sent at its due time whatever the
    queue holds, through `ServingEngine`; latency runs from the due time
    to the ids' return. Every request due in the window is waited for,
    up to `grace_s` past its close."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine({"default": rec}, max_batch=tr["max_batch"],
                           max_wait_ms=tr["max_wait_ms"])
    reqs, late = [], np.empty(len(due))
    try:
        t0 = time.perf_counter()
        for j, d in enumerate(due):
            target = t0 + d
            while (left := target - time.perf_counter()) > 0:
                time.sleep(left)
            reqs.append(engine.submit(pool[j], k=k))
            late[j] = time.perf_counter() - target
        end = t0 + seconds + tr["grace_s"]
        for r in reqs:
            r.event.wait(max(0.0, end - time.perf_counter()))
    finally:
        engine.stop()
    answers, lat, failed = {}, np.full(len(reqs), np.inf), 0
    for j, r in enumerate(reqs):
        if r.result is None:
            failed += 1
            continue
        answers[j] = r.result
        lat[j] = r.t_done - (t0 + due[j])
    log(f"[open] requests={len(reqs)} generator_late_ms "
        f"p50={np.percentile(late, 50) * 1e3:.4f} "
        f"p99={np.percentile(late, 99) * 1e3:.4f} max={late.max() * 1e3:.4f}")
    return {"answers": answers, "attempted": len(reqs), "failed": failed,
            "window_s": seconds, "latencies_s": lat[np.isfinite(lat)],
            "all_latencies_s": lat, "due_s": t0 + due}

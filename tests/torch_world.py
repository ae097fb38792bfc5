"""A world of spawned gloo ranks on the CPU for the port's distributed
tests (not a test file): `World(n)` starts n processes once, `run(module,
fn, *args)` has every rank call `module.fn(rank, *args)` and returns the
answers by rank. Every wait and join has a limit; a rank that raises
sends its traceback, which fails the test. The ranks import only torch
and the port (a test module that they call into imports jax inside its
tests)."""
import importlib
import multiprocessing as mp
import os
import queue
import traceback

WAIT_S = 120        # longest wait for one job's answers


def _rank_main(rank: int, world: int, store: str, inbox, outbox) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        while True:
            job = inbox.get(timeout=WAIT_S * 8)
            if job is None:
                break
            module, fn, args = job
            try:
                ans = getattr(importlib.import_module(module), fn)(rank,
                                                                   *args)
                outbox.put((rank, ans))
            except Exception:                     # reported, not hung
                outbox.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp: str):
        ctx = mp.get_context("spawn")
        self.n = n
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        store = os.path.join(tmp, "store")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, n, store, self.inboxes[r],
                                        self.outbox))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, module: str, fn: str, *args, wait: float = WAIT_S):
        for box in self.inboxes:
            box.put((module, fn, args))
        got = {}
        while len(got) < self.n:
            try:
                rank, ans = self.outbox.get(timeout=wait)
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(got)} answered "
                                     f"{fn} in {wait} s") from None
            assert not isinstance(ans, str), f"rank {rank}: {ans}"
            got[rank] = ans
        return got

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)

"""Fault tolerance: heartbeats and restart from the newest checkpoint
(a copy of `repro.distributed.fault_tolerance`, which is stdlib only).

The launcher contract (`repro_torch.launch.train`):
  * every worker writes a heartbeat file each step; a coordinator (or the
    cluster manager) declares a worker dead after `timeout_s` silence,
  * on failure the job restarts from the newest complete checkpoint
    (`repro_torch.checkpoint.ckpt`),
  * data streams are (seed, step)-deterministic, so the resumed run
    consumes exactly the batches the failed run would have.

`run_with_restarts` drives that loop in-process (the unit-testable core a
cluster launcher wraps); failures surface as `WorkerFailure` from
train_segment.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional


class Heartbeat:
    def __init__(self, path: str, worker: int = 0):
        self.file = os.path.join(path, f"heartbeat_{worker}.json")
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int):
        tmp = self.file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self.file)

    @staticmethod
    def dead_workers(path: str, timeout_s: float) -> list:
        now = time.time()
        dead = []
        for fn in os.listdir(path):
            if fn.startswith("heartbeat_") and fn.endswith(".json"):
                with open(os.path.join(path, fn)) as f:
                    hb = json.load(f)
                if now - hb["time"] > timeout_s:
                    dead.append(fn)
        return dead


class WorkerFailure(RuntimeError):
    pass


def run_with_restarts(train_segment: Callable[[Optional[int]], int], *,
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int], None]] = None
                      ) -> int:
    """train_segment(resume_step|None) -> final_step; raises WorkerFailure
    on simulated/real worker death. Restarts up to max_restarts times,
    resuming from the step it reports via checkpoint discovery."""
    restarts = 0
    resume: Optional[int] = None
    while True:
        try:
            return train_segment(resume)
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            resume = getattr(e, "last_step", None)
            if on_restart:
                on_restart(restarts)

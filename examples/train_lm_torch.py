"""End-to-end driver on the PyTorch/CUDA port (the port's
`examples/train_lm.py`): train a ~100M-param qwen3-family LM for a few
hundred steps with checkpointing + a mid-run simulated failure and
automatic restart.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
        [--fail-at N] [--device cpu]

Uses the launcher (`repro_torch.launch.train`) on one device (the card by
default, raising without one) with a ~100M-parameter reduction of
qwen3-1.7b: the launcher's tiny scale (float32, 128-token sequences,
batch 4) with the widths below given as `model_overrides`, which makes
the model the original's `scale_100m` makes by replacing `tiny_lm`.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (WorkerFailure,
                                                     run_with_restarts)
from repro_torch.launch import train as T

# ~100M params: 8L x d512 x ff2048, vocab 32k
WIDTHS_100M = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                   head_dim=64, d_ff=2048, vocab_size=32768)


def run(*, device=None, steps=200, fail_at=None, widths=WIDTHS_100M,
        init_state=None, workdir=None, verbose=True) -> dict:
    """Train qwen3-1.7b at `widths` (None: the launcher's tiny_lm) for
    `steps` steps, checkpointing into `workdir` (a new temporary directory
    if None, kept) every 25 steps; a WorkerFailure injected before
    step `fail_at` restarts the run from its newest checkpoint.
    `init_state` (a TrainState) replaces the launcher's seed-0 draw.
    Returns the final step, the restarts and each run's first step and
    losses (`segments`, in order)."""
    dev = resolve_device(device)
    model = T.tiny_lm(get_arch("qwen3-1.7b").model).scaled(**(widths or {}))
    ckpt = workdir or tempfile.mkdtemp(prefix="lm_ckpt_")
    injected, restarts, segments = [], [], []

    def segment(resume):
        fail = fail_at if (fail_at and not injected) else None
        if fail:
            injected.append(True)
        try:
            hist = T.train_loop("qwen3-1.7b", "train_4k", steps=steps,
                                ckpt_dir=ckpt, ckpt_every=25,
                                fail_at_step=fail, device=dev,
                                model_overrides=widths,
                                init_state=init_state, verbose=verbose)
        except WorkerFailure as e:
            segments.append({"start": e.last_step - len(e.losses),
                             "losses": list(e.losses), "failed": True})
            raise
        segments.append({"start": steps - len(hist["losses"]),
                         "losses": hist["losses"], "failed": False,
                         "wall_s": hist["wall_s"]})
        return hist["final_step"]

    def on_restart(n):
        restarts.append(n)
        if verbose:
            print(f"[launcher] restart #{n} from checkpoint")

    final = run_with_restarts(segment, max_restarts=2, on_restart=on_restart)
    return {"n_params": model.n_params(), "steps": steps,
            "final_step": final, "restarts": len(restarts),
            "segments": segments, "ckpt_dir": ckpt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a worker failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)
    model = T.tiny_lm(get_arch("qwen3-1.7b").model).scaled(**WIDTHS_100M)
    resolve_device(args.device)
    print(f"training {model.n_params()/1e6:.0f}M-param LM "
          f"for {args.steps} steps")
    out = run(device=args.device, steps=args.steps, fail_at=args.fail_at)
    print(f"done at step {out['final_step']}; checkpoints in "
          f"{out['ckpt_dir']}")


if __name__ == "__main__":
    main()

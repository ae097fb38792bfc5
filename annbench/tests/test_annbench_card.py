"""On the card: a short run of each cell is correct (the chip's own
check runs each cell at full length)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.annbench_card
@pytest.mark.parametrize("name", ["sift1m.b256", "kilt-e5.open"])
def test_cell_runs_correct_on_the_card(card, name):
    res = subprocess.run([sys.executable, "annbench/run.py", "--workload",
                          name, "--seed", "2147483659", "--seconds", "3",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"

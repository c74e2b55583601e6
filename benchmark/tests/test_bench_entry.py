"""The entry point without a card, and on one."""
import json
import os
import subprocess
import sys

import pytest

from helpers import ROOT


def test_without_cuda_it_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                     "run.py"),
                        "--workload", "facade_p25.exact", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                     "run.py"),
                        "--workload", "facade_p25.exact", "--seed", "3",
                        "--seconds", "2"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]

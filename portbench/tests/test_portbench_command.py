"""The command itself: without a card it exits non-zero and prints no
result."""
import json
import subprocess
import sys

import pytest

import core


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal is what a machine without a card sees")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dimer2d.solve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")
    assert "cuda" in proc.stderr

"""On the card: one short run of a cell prints the contract's last line,
and the control's readings separate.  Skipped without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def _run(script, *args):
    env = dict(os.environ)
    env.pop("LARA_PLATFORM", None)
    proc = subprocess.run([sys.executable, str(REPO / "gpubench" / script),
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_prints_the_result_line(card, trace):
    out = _run("run.py", "--workload", "trna72.families15", "--seed",
               "2147483999", "--seconds", "3", "--trace", trace)
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert "device.idle_share.card" in out["metrics"]
        assert "entry.alignments_per_s" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"solve_card_us_per_alignment",
                                       "setup_s"}
        assert out["metrics"]["solve_card_us_per_alignment"]["value"] > 0


@pytest.mark.cuda
def test_the_control_fails_where_the_program_passes(card):
    out = _run("control.py", "--workload", "trna72.families15", "--seed",
               "4999", "--seconds", "3")
    assert out["program_pairs_differing"] == 0
    assert out["control_pairs_differing"] > 0

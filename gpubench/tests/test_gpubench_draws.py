"""The closed loop's draws: each traffic file's first jobs at a fixed seed
hash to a digest taken on the commit that added this test, so that a change
to the generator that would move what an existing cell measures shows."""

import hashlib
import itertools
import json
from pathlib import Path

import pytest

from gpubench.traffic import generate

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"

#: sha256 of the first 50 jobs (warm-up jobs included) that each traffic
#: file draws at the seed below
DRAW_SEED = 2**31 + 2**30 + 17
DRAW_DIGESTS = {
    "families15":
        "e4939abdb61289088f7d401d64e6649b1047362121adb3c5faae603f1aed1176",
    "families64":
        "397fc71e7b1770ddd27692314e2299759b42aeba75aa90a7f81a878e473777d1",
    "families8":
        "6b8d341c24b884599dac15ea2263541bb0a7698c90773bb1e8463e9c705bd891",
    "pair":
        "b475c733eff3833651ecfec313e1e29753b4189196a4235219bae5b797d1e1f0",
}


@pytest.mark.parametrize("name", sorted(DRAW_DIGESTS))
def test_the_draws_are_as_they_were(name):
    traffic = json.loads((TRAFFIC / f"{name}.json").read_text())
    s_jobs = generate.seeds(DRAW_SEED, 2)[0]
    jobs = list(itertools.islice(generate.families(
        int(traffic["pool_size"]), int(traffic["family_size"]), s_jobs), 50))
    assert hashlib.sha256(json.dumps(jobs).encode()).hexdigest() \
        == DRAW_DIGESTS[name]

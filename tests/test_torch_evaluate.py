"""The port's copy of the quality metrics, ``lara_tpu_torch.evaluate``.

SPS, MCC, the built-in consensus structure and the ``main`` CLI give what
``lara_tpu.evaluate`` gives, exactly, on the repository's families
(``benchmark/data/*/reference.fa``, against itself and against a copy
with some sequences re-gapped) and on an MSA the port wrote with ``--msa``.
"""

import os

import pytest
import torch

from lara_tpu import evaluate as jax_evaluate
from lara_tpu_torch import app, evaluate
from lara_tpu_torch.params import Parameters

from tests.test_device_solver import write_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("trna", "rrna5s", "srp")


def _reference(family):
    return os.path.join(REPO, "benchmark", "data", family, "reference.fa")


def _regapped(path, out):
    """``path`` with every third sequence's residues moved to the left and
    its gaps to the end: another alignment of the same sequences."""
    msa = evaluate.read_msa(path)
    width = len(msa[0][1])
    with open(out, "w") as handle:
        for k, (name, gapped) in enumerate(msa):
            if k % 3 == 0:
                residues = "".join(c for c in gapped if c not in "-.~")
                gapped = residues + "-" * (width - len(residues))
            handle.write(f">{name}\n{gapped}\n")
    return str(out)


@pytest.fixture(scope="module")
def port_msa(tmp_path_factory):
    """An MSA the port assembled (``app.run`` with ``--msa``)."""
    tmp = tmp_path_factory.mktemp("msa")
    path = write_family(tmp, n=5, seed=7)
    msa = tmp / "port.msa.fa"
    app.run(Parameters(in_file=path, num_iterations=40,
                       out_file=str(tmp / "port.lib"), msa_file=str(msa)),
            devices=[torch.device("cpu")])
    return str(msa)


@pytest.mark.parametrize("family", FAMILIES)
def test_sps_equals_the_original(family, tmp_path):
    ref = _reference(family)
    test = _regapped(ref, tmp_path / "test.fa")
    for a, b in ((ref, ref), (ref, test), (test, ref)):
        assert evaluate.sps(a, b) == jax_evaluate.sps(a, b)
    assert evaluate.sps(ref, ref) == 1.0 and evaluate.sps(ref, test) < 1.0


@pytest.mark.parametrize("family", ["trna", "rrna5s"])
def test_consensus_builtin_equals_the_original(family):
    msa = evaluate.read_msa(_reference(family))
    assert msa == jax_evaluate.read_msa(_reference(family))
    structure = evaluate.consensus_structure_builtin(msa)
    assert structure == jax_evaluate.consensus_structure_builtin(msa)
    assert structure.count("(") == structure.count(")") > 0


def test_mcc_equals_the_original(tmp_path):
    ref = _reference("trna")
    test = _regapped(ref, tmp_path / "test.fa")
    got = evaluate.mcc(ref, test, "builtin")
    assert got == jax_evaluate.mcc(ref, test, "builtin")
    assert -1.0 <= got <= 1.0


def test_metrics_on_a_port_msa(port_msa, tmp_path):
    test = _regapped(port_msa, tmp_path / "test.fa")
    msa = evaluate.read_msa(port_msa)
    assert len(msa) == 5
    assert evaluate.consensus_structure_builtin(msa) == \
        jax_evaluate.consensus_structure_builtin(msa)
    for a, b in ((port_msa, test), (test, port_msa)):
        assert evaluate.sps(a, b) == jax_evaluate.sps(a, b)
        assert evaluate.mcc(a, b, "builtin") == \
            jax_evaluate.mcc(a, b, "builtin")


@pytest.mark.parametrize("argv", [
    ["sps", "{ref}", "{test}"],
    ["mcc", "{ref}", "{test}", "--consensus", "builtin"],
    ["mcc", "{test}", "{test}", "--consensus", "builtin"],
])
def test_main_equals_the_original(argv, port_msa, tmp_path, capsys):
    test = _regapped(port_msa, tmp_path / "test.fa")
    args = [a.format(ref=port_msa, test=test) for a in argv]
    assert evaluate.main(args) == 0
    got = capsys.readouterr().out
    assert jax_evaluate.main(args) == 0
    assert got == capsys.readouterr().out
    float(got)

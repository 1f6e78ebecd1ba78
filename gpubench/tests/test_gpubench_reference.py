"""The frozen reference under ``gpubench/reference`` against the port it
was copied from, and against the port's solve on the CPU."""

import numpy as np
import pytest

from gpubench.reference import control, oracle, records, ribosum, types, \
    writer
from gpubench.reference import driver as ref_driver
from gpubench.reference.params import Parameters as RefParameters
from gpubench.traffic import generate


def _family_file(tmp_path, n=3, length=30, seed=3):
    path = str(tmp_path / "family.ebpseq")
    generate.write_ebpseq(generate.make_family(n, length, seed), path)
    return path


def test_tables_equal_the_port():
    from lara_tpu_torch import types as port_types
    from lara_tpu_torch.scoring import ribosum as port_ribosum

    assert (ribosum.ribosum65n_fixed()
            == port_ribosum.ribosum65n_fixed()).all()
    assert types.INFINITY == port_types.INFINITY
    assert types.PSSM_INIT == port_types.PSSM_INIT
    seq = "ACGUNTacgux"
    assert (ribosum.encode_rna5(seq) == port_ribosum.encode_rna5(seq)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_equals_the_port(seed):
    from lara_tpu_torch.solver import oracle as port_oracle

    rng = np.random.default_rng(seed)
    pssm = rng.integers(-40000, 40000, size=(11, 9)).astype(np.int64)
    assert oracle.align_pssm(pssm, -49152, -16384) \
        == port_oracle.align_pssm(pssm, -49152, -16384)
    a = rng.integers(0, 5, 13).astype(np.int8)
    b = rng.integers(0, 5, 10).astype(np.int8)
    mat = ribosum.ribosum65n_fixed()
    got = oracle.generate_edges(a, b, mat, -49152, -16384, 327680)
    want = port_oracle.generate_edges(a, b, mat, -49152, -16384, 327680)
    assert (got[0] == want[0]).all() and got[1] == want[1]


def test_reader_and_writer_equal_the_port(tmp_path):
    from lara_tpu_torch.io import readers
    from lara_tpu_torch.io.writers import OutputLibrary

    path = _family_file(tmp_path)
    ours = records.read_ebpseq(path)
    theirs = readers.read_rna_file(path)
    assert [(r.name, r.sequence, r.bpp_edges) for r in ours] \
        == [(r.name, r.sequence, r.bpp_edges) for r in theirs]
    results = [ref_driver.solve_pair(ours[1], ours[0], RefParameters(
        num_iterations=5), (1, 0))]
    lib = OutputLibrary(theirs)
    for r in results:
        lib.add_alignment(r.seq_indices, r.columns, r.score)
    assert writer.library(ours, results) == lib.to_string()
    head, blocks, foot = writer.split(lib.to_string())
    assert head == writer.header(ours) and foot == writer.FOOTER
    assert blocks == {(0, 1): [writer.block((0, 1), results[0].columns)]}


@pytest.mark.parametrize("length,iterations", [(30, 20), (44, 12)])
def test_reference_equals_the_port_on_the_cpu(tmp_path, cpu, length,
                                              iterations):
    """The frozen mirror equals the port's solve on the CPU at tiny
    sizes: every pair's answer and the library's bytes."""
    import torch

    from lara_tpu_torch import app
    from lara_tpu_torch.params import Parameters

    path = _family_file(tmp_path, n=3, length=length, seed=length)
    out = str(tmp_path / "family.lib")
    run = app.run(Parameters(in_file=path, out_file=out, threads=2,
                             num_iterations=iterations), torch.device("cpu"))
    store = records.read_ebpseq(path)
    params = RefParameters(num_iterations=iterations)
    want = []
    for r in run.results:
        i, j = r.seq_indices
        a, b = (i, j) if len(store[i]) >= len(store[j]) else (j, i)
        ref = ref_driver.solve_pair(store[a], store[b], params, (a, b))
        assert (ref.columns, ref.score, ref.best_lower, ref.best_upper,
                ref.iterations) == (r.columns, r.score, r.best_lower,
                                    r.best_upper, r.iterations)
        want.append(ref)
    with open(out) as handle:
        assert handle.read() == writer.library(store, want)


def test_bfloat16_rounding():
    assert control.to_bfloat16(1.0) == np.float32(1.0)
    assert control.to_bfloat16(3.14159) == np.float32(3.140625)
    # ties to even at the last kept bit
    assert control.to_bfloat16(np.float32(1 + 2 ** -8)) == np.float32(1.0)
    assert control.to_bfloat16(np.float32(1 + 3 * 2 ** -8)) \
        == np.float32(1 + 2 ** -6)
    assert control.to_bfloat16(-1000001.0) == np.float32(-999424.0)


def test_float32_rounding_is_the_mirror(tmp_path):
    """``rounding=np.float32`` (the default) is the port's mirror, bit for
    bit."""
    from lara_tpu_torch.params import Parameters
    from lara_tpu_torch.solver import reference_driver

    from lara_tpu_torch.io import readers

    path = _family_file(tmp_path, n=2, length=40, seed=9)
    ours = records.read_ebpseq(path)
    theirs = readers.read_rna_file(path)
    got = ref_driver.solve_pair(ours[0], ours[1],
                                RefParameters(num_iterations=30), (0, 1))
    want = reference_driver.solve_pair(theirs[0], theirs[1],
                                       Parameters(num_iterations=30), (0, 1))
    assert (got.columns, got.score, got.best_upper, got.iterations) \
        == (want.columns, want.score, want.best_upper, want.iterations)

"""The port's accuracy_hybrid and accuracy_longread (the PacBio family)
against the JAX package's, on the CPU, stage by stage, as
tests/test_torch_accuracy_sim_trio.py runs its drivers (the same seeded
stand-ins, the twin model, the JAX package evaluating the port's
checkpoint; tolerances of tests/torch_accuracy_util.py), and
resolve_channels (test_accuracy_family_units.py's case) on both
packages."""

import pytest
import torch

from deepvariant_tpu_torch.testing import accuracy_inputs
from torch_accuracy_util import (
    COMMON,
    JAX,
    PORT,
    assert_workdirs_equal,
    patch_both,
    run_both,
    script,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return accuracy_inputs.write_inputs(str(tmp_path_factory.mktemp("in")))


def test_accuracy_hybrid_equals_jax(inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    port, want = run_both("accuracy_hybrid", COMMON + [
        "--seeds", "701", "--eval_seed", "90777"], tmp_path)
    assert port == want
    assert port["oracle"]["all"]["tp"] > 0
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT) > 20


def test_accuracy_longread_pacbio_equals_jax(inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    port, want = run_both("accuracy_longread", COMMON + [
        "--family", "pacbio", "--seeds", "101"], tmp_path)
    assert port["eval"] == want["eval"]
    assert port["corpus"]["train"] > 0 and want["corpus"] is None
    assert port["eval"]["oracle_confident"]["all"]["tp"] > 0
    # report.json: the JAX run that evaluates holds no corpus counts.
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT,
                                 ignore=("report.json",)) > 10


@pytest.mark.parametrize("family,extra", [
    ("ont", ""), ("ont", "16,17,26"), ("pacbio", "28,29,30"),
    ("pacbio", "26")])
def test_resolve_channels_equals_jax(family, extra):
    got = script(PORT, "accuracy_longread").resolve_channels(family, extra)
    assert got == script(JAX, "accuracy_longread").resolve_channels(
        family, extra)
    if not extra:
        assert got is None
    else:
        assert len(set(got)) == len(got)
    if extra == "16,17,26":
        assert got.count(26) == 1 and got[-2:] == [16, 17]

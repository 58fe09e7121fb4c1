"""The port's accuracy_sim and accuracy_trio drivers against the JAX
package's, on the CPU, stage by stage.

Both packages' drivers are pointed at the same seeded stand-ins
(`testing/accuracy_inputs.py`: windows of a few kb, a held-out corpus
in place of the real eval runs) and train the twin model of
torch_train_util (patched into both packages' `create_model`). Each
port driver runs gen, train and eval; the JAX driver runs gen and
train, then eval with the port's checkpoint, so both evaluate the same
checkpoint. The work directories are compared as
tests/torch_accuracy_util.py says (corpora and labeled TFRecords
byte for byte, trained states to 1e-5 relative plus 1e-6 absolute, CVO
probabilities to 1e-5), and the F1 JSON the drivers print, the fn
audits and the reports must be equal. The unit cases of
tests/test_accuracy_family_units.py that the two drivers own run on
both packages."""

import numpy as np
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


def test_accuracy_sim_equals_jax(inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    port, want = run_both("accuracy_sim", COMMON + [
        "--seeds", "101", "--coverage", "30", "--eval_span", "6000-7200"],
        tmp_path, report="md")
    assert port == want
    assert port["train_examples"] > 0
    assert port["oracle"]["all"]["tp"] > 0
    n = assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT)
    assert n > 20
    with open(tmp_path / f"{JAX}.md") as f:
        jax_report = f.read()
    with open(tmp_path / f"{PORT}.md") as f:
        assert f.read() == jax_report.replace(
            "device-resident TPU loop", "device-resident loop").replace(
            "deepvariant_tpu.scripts", "deepvariant_tpu_torch.scripts")


def test_accuracy_trio_equals_jax(inputs, tmp_path, monkeypatch):
    patch_both(monkeypatch, inputs)
    port, want = run_both("accuracy_trio", COMMON + [
        "--seeds", "501", "--eval_seed", "90555"], tmp_path)
    assert port == want
    assert port["oracle"]["all"]["tp"] > 0
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT) > 20


@pytest.mark.parametrize("spec", ["101,202", "101,202,303@hg001",
                                  "7@indelrich,8@na12878", "5@nope"])
def test_parse_seeds_equals_jax(spec):
    got, want = [], []
    for package, out in ((PORT, got), (JAX, want)):
        try:
            out.append(script(package, "accuracy_sim").parse_seeds(spec))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert got == want


@pytest.mark.parametrize("windows", [[(0, 1)], [(10, 64_010)],
                                     [(1_000, 200_000), (300_000, 300_100)]])
def test_chunk_regions_equal_jax(windows):
    for name, args in (("accuracy_sim", ("chr20", windows)),
                       ("accuracy_trio", (windows,))):
        assert script(PORT, name)._chunk_regions(*args) == \
            script(JAX, name)._chunk_regions(*args)


def test_merge_tfrecords_capped_stride(tmp_path):
    """test_accuracy_family_units.py's case on both packages: the even
    stride across all parts, and the plain merge without a cap; the
    merged files hold the same records."""
    from deepvariant_tpu_torch.io import tfrecord

    parts = []
    for p in range(3):
        path = str(tmp_path / f"part{p}.tfrecord.gz")
        with tfrecord.TFRecordWriter(path) as w:
            for i in range(50):
                w.write(bytes([p]) * 4 + i.to_bytes(2, "little"))
        parts.append(path)
    merged = {}
    for package in (PORT, JAX):
        trio = script(package, "accuracy_trio")
        out = str(tmp_path / f"{package}.tfrecord.gz")
        assert trio._merge_tfrecords_capped(parts, out, cap=60) == 60
        merged[package] = list(tfrecord.read_tfrecords(out))
        whole = str(tmp_path / f"{package}-all.tfrecord.gz")
        assert trio._merge_tfrecords_capped(parts, whole, cap=None) == 150
    assert merged[PORT] == merged[JAX]
    assert len(merged[PORT]) == 60
    assert {r[0] for r in merged[PORT]} == {0, 1, 2}
    assert np.all(np.diff([r[0] * 50 + int.from_bytes(r[4:], "little")
                           for r in merged[PORT]]) > 0)

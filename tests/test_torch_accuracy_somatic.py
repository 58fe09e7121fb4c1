"""The port's accuracy_somatic and resume_somatic_eval against the JAX
package's, on the CPU, stage by stage, and the simulator cases of
tests/test_accuracy_family_units.py on both packages.

The drivers run as tests/test_torch_accuracy_sim_trio.py runs
accuracy_trio (the same seeded stand-ins, the twin model, the JAX
package evaluating the port's checkpoint; tolerances of
tests/torch_accuracy_util.py). resume_somatic_eval then restarts each
package's eval from its own cached stage-1 files with the same weights
(the JAX package's final checkpoint replaced by the port's EMA
weights): their JSON must be equal, and equal to the eval's. The truth
class convention runs on the seeded FASTA in place of the reference
FASTA the JAX test reads."""

import functools
import os

import numpy as np
import pytest
import torch

from deepvariant_tpu_torch.testing import accuracy_inputs
from torch_accuracy_util import (
    COMMON,
    JAX,
    PORT,
    assert_workdirs_equal,
    ema_bundle,
    patch_both,
    run_both,
    run_main,
)
from torch_multisample_util import module
from torch_sim_util import file_bytes, plain

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return accuracy_inputs.write_inputs(str(tmp_path_factory.mktemp("in")))


def test_accuracy_somatic_and_resume_equal_jax(inputs, tmp_path,
                                               monkeypatch):
    patch_both(monkeypatch, inputs)
    port, want = run_both("accuracy_somatic", COMMON + [
        "--seeds", "601", "--eval_seed", "90666"], tmp_path)
    assert port == want
    assert port["germline_sites"] > 0 and port["vaf_strata"]
    assert assert_workdirs_equal(tmp_path / JAX, tmp_path / PORT) > 20

    pdir, jdir = tmp_path / PORT, tmp_path / JAX
    ckpts = jdir / "experiment" / "checkpoints"
    bundle = ema_bundle(str(pdir / "experiment" / "checkpoints" /
                            "final.msgpack"), str(tmp_path / "ema"))
    with open(bundle, "rb") as f, open(ckpts / "final.msgpack", "wb") as g:
        g.write(f.read())
    resumed = {}
    for package, workdir in ((PORT, pdir), (JAX, jdir)):
        argv = ["--workdir", str(workdir), "--batch_size", "8",
                "--report", str(tmp_path / f"{package}-resumed.json")]
        if package == PORT:
            argv += ["--device", "cpu"]
        resumed[package] = run_main(package, "resume_somatic_eval", argv)
    assert resumed[PORT] == resumed[JAX]
    assert resumed[PORT]["model"] == port["model"]
    assert resumed[PORT]["vaf_strata"] == port["vaf_strata"]


def test_somatic_truth_class_convention(inputs, tmp_path):
    """truth_training encodes germline as 0/1 (class 1 = GERMLINE) and
    somatic as 1/1 (class 2 = SOMATIC) regardless of real zygosity; the
    corpus equals the JAX package's byte for byte."""
    from deepvariant_tpu_torch.io.vcf import VcfReader

    results = {}
    for package in (PORT, JAX):
        family = module(package, "training.simulate_family")
        out = tmp_path / package
        results[package] = plain(family.simulate_somatic_corpus(
            family.SomaticSimConfig(
                ref_path=inputs["ref"], contig=accuracy_inputs.CONTIG,
                windows=[(3_000, 9_000)], seed=5, coverage_tumor=8.0,
                coverage_normal=4.0, template_bam=inputs["short_template"],
                template_region=(accuracy_inputs.CONTIG, 0,
                                 accuracy_inputs.SHORT_TEMPLATE_LENGTH)),
            str(out)), str(out))
        assert file_bytes(out) == file_bytes(tmp_path / PORT)
    assert results[PORT] == results[JAX]
    sim = results[PORT]
    somatic_pos = {v["pos"] for v in sim["somatic_variants"]}
    with VcfReader(str(tmp_path / PORT / sim["truth_training"])) as r:
        recs = list(r)
    assert recs and somatic_pos
    for rec in recs:
        gt = sorted(rec.calls[0].genotype)
        assert gt == ([1, 1] if rec.start in somatic_pos else [0, 1])
    with VcfReader(str(tmp_path / PORT / sim["truth_somatic"])) as r:
        for rec in r:
            assert sorted(rec.calls[0].genotype) == [1, 1]
            assert "VAF" in rec.info


def test_non_colliding_guard():
    out = {}
    for package in (PORT, JAX):
        sim = module(package, "training.simulate")
        family = module(package, "training.simulate_family")
        v = sim.SimVariant
        taken = [v(100, "A", "T", (0, 1)), v(200, "ACGTACGTACG", "A", (0, 1))]
        cands = [v(98, "C", "G", (0, 1)), v(150, "C", "G", (0, 1)),
                 v(209, "G", "C", (0, 1)), v(215, "G", "C", (0, 1))]
        out[package] = [x.pos for x in
                        family._non_colliding(cands, taken, guard=2)]
    assert out[PORT] == out[JAX] == [150, 215]


@pytest.mark.parametrize("seed,rate", [(3, 1e-5), (4, 1e-4), (5, 0.0)])
def test_transmit_deterministic_and_mendelian(seed, rate):
    pos = np.arange(0, 1_000_000, 1000)
    out = {}
    for package in (PORT, JAX):
        transmit = module(package, "training.simulate_family")._transmit
        run = functools.partial(transmit, np.random.default_rng(seed), pos,
                                0, 1_000_000, rate=rate)
        out[package] = np.asarray(run())
    np.testing.assert_array_equal(out[PORT], out[JAX])
    t = out[PORT]
    assert set(np.unique(t)) <= {0, 1}
    switches = int((np.diff(t) != 0).sum())
    if rate == 1e-5:
        assert switches < 50  # Poisson(10) with a wide margin
    if rate == 0.0:
        assert switches == 0

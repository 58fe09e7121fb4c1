"""The port's multi-process pipeline (deepvariant_tpu_torch.parallel.
multihost) with two real processes on the CPU, against its one-process
run and the JAX package's one-process `run_host` on the same seeded
sample.

Two `python -m deepvariant_tpu_torch.parallel.multihost --device cpu`
processes meet over gloo through a file store, each runs make_examples
over its round-robin regions (WGS preset, realigner off) and the toy
classifier, and rank 0 merges the shards. Both ranks must gather the
same per-process counts; the merged VCF must equal, byte for byte, the
port's one-process run and the JAX package's (`num_processes=None`: the
JAX two-process test needs testdata absent here, its one-process path
runs). The toy probabilities agree with JAX's to 1e-6."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvariant_tpu.io.bgzf import BgzfReader
from deepvariant_tpu.parallel import multihost as jax_multihost
from deepvariant_tpu_torch.parallel import multihost
from torch_dist_util import PROCESS_TIMEOUT_S, REPO
from torch_port_util import stage1_sample, write_stage1_inputs

torch.set_num_threads(2)

REGIONS = ["chr1:1-1500", "chr1:1501-3000", "chr1:3001-6000",
           "chr2:1-3000"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    paths = write_stage1_inputs(stage1_sample(11),
                                tmp_path_factory.mktemp("sample"))
    return dict(reads_filename=paths["reads"], ref_filename=paths["ref"],
                examples_filename="", mode="calling",
                realigner_enabled=False, write_run_info=False)


def _two_processes(options, workdir):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    store = f"file://{workdir}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deepvariant_tpu_torch.parallel.multihost",
         "--workdir", workdir, "--coordinator", store,
         "--num_processes", "2", "--process_id", str(pid),
         "--options_json", json.dumps(options),
         "--regions_json", json.dumps(REGIONS), "--sample_name", "HG002",
         "--device", "cpu", "--timeout_s", "120"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {o["process_id"]: o for o in outs}


def test_two_processes_match_one_process_and_jax(inputs, tmp_path):
    workdir = str(tmp_path / "two")
    os.makedirs(workdir)
    by_pid = _two_processes(inputs, workdir)
    assert by_pid[0]["process_count"] == by_pid[1]["process_count"] == 2
    assert by_pid[0]["all_counts"] == by_pid[1]["all_counts"] == [
        by_pid[0]["local_examples"], by_pid[1]["local_examples"]]
    assert min(by_pid[0]["all_counts"]) > 0
    assert "output_vcf" not in by_pid[1]

    one_dir = str(tmp_path / "one")
    os.makedirs(one_dir)
    one = multihost.run_host(one_dir, inputs, REGIONS, sample_name="HG002",
                             device="cpu")
    assert (one["process_id"], one["process_count"]) == (0, 1)
    assert one["all_counts"] == [sum(by_pid[0]["all_counts"])]
    jax_dir = str(tmp_path / "jax")
    os.makedirs(jax_dir)
    want = jax_multihost.run_host(jax_dir, inputs, REGIONS,
                                  num_processes=None, sample_name="HG002")
    assert want["local_examples"] == one["local_examples"]

    two_vcf = BgzfReader(by_pid[0]["output_vcf"]).read_all()
    one_vcf = BgzfReader(one["output_vcf"]).read_all()
    jax_vcf = BgzfReader(want["output_vcf"]).read_all()
    # Multi-allelic groups merge, so fewer records than examples.
    assert 10 < two_vcf.count(b"\nchr") <= sum(by_pid[0]["all_counts"])
    assert two_vcf == one_vcf == jax_vcf
    with open(by_pid[0]["output_vcf"], "rb") as f, \
            open(one["output_vcf"], "rb") as g:
        assert f.read() == g.read()


def test_toy_probabilities_match_jax():
    images = np.random.RandomState(3).randint(0, 255, (6, 10, 12, 7),
                                              np.uint8)
    images[0] = 0
    got = multihost._toy_probabilities(images, "cpu")
    want = jax_multihost._toy_probabilities(images)
    assert got.dtype == np.float32 and got.shape == (6, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

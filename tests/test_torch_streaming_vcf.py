"""The slice as a whole: a BAM and a FASTA to a VCF through the port's
`run_streaming_pipeline` (two spawned workers, PlanPredictor, stage 3 on
the CVOs in memory), against the JAX package's
`run_streaming_pipeline(device_encode=True)` on the same files and the
same weights, float32, on the CPU.

Two samples: the WGS preset with its defaults (realigner on) on the
sparse short-read sample (a fifth of `chip_smoke.py` phase 8's), and the
PACBIO preset with its defaults (direct phasing on, phase info out) on
the seeded long-read sample.

Tolerance: the CNN's, 1e-5 on each genotype probability (conv sums'
order; `tests/test_torch_plan_predictor.py`). Everything after it is
exact. So the VCFs are compared record by record: wherever every CVO of
a record's group has the same `round_gls` probabilities in both
packages, the record lines are byte-identical; the test counts the
records where the 1e-5 bites (none at these sizes, and it says so if
that changes). And the port's VCF is byte-identical to what the JAX
package's `postprocess_variants` writes from the port's own CVOs.
"""

import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepvariant_tpu.calling import plan_predictor as jax_plan
from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io.fasta import FastaReader
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.parallel import stream_pipeline as jsp
from deepvariant_tpu.postprocess import pipeline as jpipe
from deepvariant_tpu_torch.io import tabix as ttabix
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.parallel import stream_pipeline as sp
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    preset_options,
    random_flax_variables,
    sparse_sample,
    write_stage1_inputs,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
BATCH = 8

CASES = {
    # A fifth of chip_smoke.py phase 8: a variant every 400-500 bases.
    "wgs-defaults": dict(
        sample=lambda: sparse_sample(8, (("chr1", 5200), ("chr2", 2800))),
        preset="WGS", channels=7, overrides={}, suffix=".vcf.gz"),
    "pacbio-defaults": dict(
        sample=lambda: synthetic.synthetic_longread_sample(
            5, (("chr1", 6000), ("chr2", 3000)), depth=12,
            mean_read_length=2000),
        preset="PACBIO", channels=10,
        overrides=dict(output_phase_info=True, partition_size=3000),
        suffix=".vcf"),
}


def capture_cvos(monkeypatch, module):
    """Record the CVOs that `module.run_streaming_pipeline` hands to
    stage 3 (its stream_examples_to_cvos result), as copies: stage 3
    writes the calls into the CVOs' variants."""
    seen = []
    plain = module.stream_examples_to_cvos

    def recording(*args, **kwargs):
        result = plain(*args, **kwargs)
        seen.append([type(c).decode(c.encode()) for c in result[0]])
        return result

    monkeypatch.setattr(module, "stream_examples_to_cvos", recording)
    return seen


def locus(cvo):
    return (cvo.variant.reference_name, cvo.variant.start, cvo.variant.end,
            tuple(cvo.alt_allele_indices))


def body(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    head = [line for line in lines if line.startswith("#")]
    return head, [line for line in lines if not line.startswith("#")]


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_vcf_matches_jax(name, tmp_path, monkeypatch):
    case = CASES[name]
    paths = write_stage1_inputs(case["sample"](), tmp_path / "in")
    variables = random_flax_variables(case["channels"], seed=4)
    model = iv3.InceptionV3(case["channels"])
    model.load_state_dict(iv3.from_flax_variables(variables))

    def options(package):
        return preset_options(package, paths, case["preset"],
                              **case["overrides"])

    port_seen = capture_cvos(monkeypatch, sp)
    jax_seen = capture_cvos(monkeypatch, jsp)
    out = str(tmp_path / f"port{case['suffix']}")
    got = sp.run_streaming_pipeline(
        options(PORT), out, paths["ref"], model=model, num_workers=2,
        batch_size=BATCH, device_encode=True, device="cpu",
        dtype=torch.float32)
    jout = str(tmp_path / f"jax{case['suffix']}")
    pileup = options(JAX).pileup_options
    want = jsp.run_streaming_pipeline(
        options(JAX), jout, paths["ref"], num_workers=2, batch_size=BATCH,
        device_encode=True,
        plan_predictor_factory=lambda: jax_plan.PlanPredictor(
            variables, pileup, batch_size=BATCH,
            model=jax_iv3.InceptionV3(dtype=jnp.float32)))
    assert sorted(got) == sorted(want)
    assert got["stream_examples"] == want["stream_examples"] >= 8
    assert got["postprocess"]["vcf_records"] == \
        want["postprocess"]["vcf_records"] > 5
    assert got["stream_device_encode"] is True

    # The CVOs: the same loci and variants; probabilities to 1e-5.
    (port_cvos,), (jax_cvos,) = port_seen, jax_seen
    port_by = {locus(c): c for c in port_cvos}
    jax_by = {locus(c): c for c in jax_cvos}
    assert sorted(port_by) == sorted(jax_by)
    differ = set()
    for key, c in port_by.items():
        j = jax_by[key]
        assert c.variant.encode() == j.variant.encode()
        np.testing.assert_allclose(c.genotype_probabilities,
                                   j.genotype_probabilities, atol=1e-5,
                                   rtol=0)
        if c.genotype_probabilities != j.genotype_probabilities:
            differ.add(key[:3])

    # The VCFs: the same header; a record line differs only where the
    # CNN's 1e-5 changed a rounded probability of its group.
    head, lines = body(out)
    jhead, jlines = body(jout)
    assert head == jhead and len(lines) == len(jlines)
    bites = []
    for line, jline in zip(lines, jlines):
        if line != jline:
            fields = line.split("\t")
            bites.append((fields[0], int(fields[1]) - 1))
            assert any(k[0] == fields[0] and k[1] == int(fields[1]) - 1
                       for k in differ), (line, jline)
    assert not bites, f"the CNN's 1e-5 bites at {bites}"
    if name == "pacbio-defaults":
        # The workers phased reads and put phase info on the candidates.
        assert any("PS_CONTIG" in c.variant.info for c in port_cvos)

    # The port's VCF is the JAX package's postprocess of the port's CVOs.
    again = str(tmp_path / f"jax-of-port{case['suffix']}")
    jpipe.postprocess_variants(
        [jt.CallVariantsOutput.decode(c.encode()) for c in port_cvos],
        again, FastaReader(paths["ref"]).contigs)
    with open(out, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    if case["suffix"] == ".vcf.gz":
        index = ttabix.build_index(out)
        reader = ttabix.TabixReader(out, index)
        first = lines[0].split("\t")
        pos = int(first[1]) - 1
        assert lines[0] in list(reader.query(first[0], pos, pos + 1))


def test_run_streaming_pipeline_refuses_as_the_stream_does(tmp_path):
    """Host encoding is ported: `run_streaming_pipeline` without
    `device_encode` paints on the workers and writes the VCF, and with
    `output_gvcf` the gVCF beside it; both VCFs are the device-encode
    run's, byte for byte (float32 on the CPU, no record where a rounded
    probability moved at this size). A missing card still raises."""
    paths = write_stage1_inputs(
        sparse_sample(8, (("chr1", 2000),)), tmp_path / "in")
    options = preset_options(PORT, paths, "WGS")
    torch.manual_seed(3)
    model = iv3.InceptionV3(7)
    written = {}
    for name, encode, gvcf in (("host", False, ""),
                               ("host-gvcf", False, "g.vcf"),
                               ("device", True, "")):
        out = str(tmp_path / f"{name}.vcf")
        result = sp.run_streaming_pipeline(
            options, out, paths["ref"], model=model, device="cpu",
            dtype=torch.float32, batch_size=BATCH, device_encode=encode,
            output_gvcf=str(tmp_path / gvcf) if gvcf else "")
        assert result["stream_device_encode"] is encode
        assert result["postprocess"]["vcf_records"] > 1
        with open(out) as f:
            written[name] = f.read()
        if gvcf:
            assert result["stream_gvcf_records"] > 10
            assert result["postprocess"]["gvcf_records"] > 10
    assert written["host"] == written["host-gvcf"] == written["device"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            sp.run_streaming_pipeline(options, str(tmp_path / "a.vcf"),
                                      paths["ref"], model=iv3.InceptionV3(7),
                                      device_encode=True)
    import inspect

    want = list(inspect.signature(jsp.run_streaming_pipeline).parameters)
    got = list(inspect.signature(sp.run_streaming_pipeline).parameters)
    assert got == want + ["device", "dtype"]

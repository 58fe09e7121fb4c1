"""The slice as a whole: reads file + reference file -> candidates ->
plans -> worker queues -> PlanPredictor -> CVOs, the port's
`stream_examples_to_cvos(device_encode=True)` against the JAX package.

Both sides get the same files (the shared synthetic sample, written by
the JAX package's BamWriter) and the same weights (numpy seed, carried
across by `from_flax_variables`), float32, on the CPU. The port runs the
real thing: two spawned workers feeding its PlanPredictor. The JAX side
runs in this process, `make_examples_runner(plan_sink=...)` for each of
the two shards and then its `PlanPredictor`: that is what its stream
path computes, without spawning JAX worker processes under xdist, which
only adds start-up time and another way to time out.

After sorting by locus the CVOs' variants and alt_allele_indices are
identical (exact); genotype probabilities agree to 1e-5 with equal
argmax, the tolerance `tests/test_torch_plan_predictor.py` states for
the fused path (bit-identical images, the conv sums' order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepvariant_tpu.calling import plan_predictor as jax_plan
from deepvariant_tpu.core.genomics_math import round_gls
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu_torch.calling import plan_predictor as plan
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.parallel import stream_pipeline as sp
from torch_port_util import (
    preset_options,
    random_flax_variables,
    sparse_sample,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
REGIONS = ["chr1:1,000-2,500", "chr2:200-1,100"]
BATCH = 8


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("jax_in"))


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(7, seed=4)


@pytest.fixture(scope="module")
def model(variables):
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(variables))
    return model


def locus(cvo):
    return (cvo.variant.reference_name, cvo.variant.start,
            cvo.variant.end, tuple(cvo.alt_allele_indices))


def test_stream_cvos_match_jax(paths, variables, model):
    got = check_stream_against_jax(paths, variables, model, wgs_options, 24)
    assert any(len(c.alt_allele_indices) == 2 for c in got)


@pytest.fixture(scope="module")
def sparse_paths(tmp_path_factory):
    return write_stage1_inputs(sparse_sample(),
                               tmp_path_factory.mktemp("sparse_in"))


def test_stream_cvos_match_jax_with_the_realigner(sparse_paths, variables,
                                                  model):
    """The WGS preset as it is, realigner on, on the sample whose windows
    assemble: the spawned workers realign, and the CVOs are the JAX
    package's (native library loaded)."""
    check_stream_against_jax(sparse_paths, variables, model, preset_options,
                             6)
    # The realigner changed what was called: the same stream without it
    # gives other plans.
    on, off = [], []
    for sink, make in ((on, preset_options), (off, wgs_options)):
        jcore.make_examples_runner(make(JAX, sparse_paths, regions=REGIONS),
                                   plan_sink=sink.append)
    assert len(on) != len(off) or any(
        not np.array_equal(a.plan["bases"], b.plan["bases"])
        for a, b in zip(on, off))


def check_stream_against_jax(paths, variables, model, make_options,
                             at_least):
    """The port's stream with 2 spawned workers against the JAX package's
    runner and predictor in this process; returns the port's CVOs sorted
    by locus. `make_options(package, paths, **overrides)` builds the
    options of either package."""
    cvos, stats, gvcfs = sp.stream_examples_to_cvos(
        make_options(PORT, paths, regions=REGIONS), 2, model=model,
        batch_size=BATCH, device_encode=True, device="cpu",
        dtype=torch.float32)
    assert gvcfs is None
    assert stats.device_encode and stats.num_cvos == len(cvos)
    assert stats.num_examples == len(cvos) >= at_least
    assert sorted(stats.stage1_counts) == [0, 1]
    assert all(c["examples"] > 0 for c in stats.stage1_counts.values())
    assert stats.examples_per_sec > 0 and stats.wall_seconds > 0

    # The JAX side, in process: both shards' plans, then its predictor.
    planned = []
    for task in (0, 1):
        jcore.make_examples_runner(
            make_options(JAX, paths, regions=REGIONS, task_id=task,
                         num_shards=2),
            plan_sink=planned.append)
    assert len(planned) == len(cvos)
    predictor = jax_plan.PlanPredictor(
        variables, wgs_options(JAX, paths).pileup_options, batch_size=BATCH,
        model=jax_iv3.InceptionV3(dtype=jnp.float32))
    want = []
    for rec, probs in predictor.predict_plan_stream(planned):
        want.append((rec, round_gls([float(p) for p in probs])))

    got = sorted(cvos, key=locus)
    want.sort(key=lambda pair: (
        pair[0].variant.reference_name, pair[0].variant.start,
        pair[0].variant.end, tuple(pair[0].alt_indices)))
    assert len({locus(c) for c in got}) == len(got)
    for cvo, (rec, probs) in zip(got, want):
        assert cvo.variant.encode() == rec.variant.encode()
        assert cvo.alt_allele_indices == rec.alt_indices
        assert abs(sum(cvo.genotype_probabilities) - 1.0) < 1e-9
        np.testing.assert_allclose(cvo.genotype_probabilities, probs,
                                   atol=1e-5, rtol=0)
        assert int(np.argmax(cvo.genotype_probabilities)) == \
            int(np.argmax(probs))
    assert {c.variant.reference_name for c in got} == {"chr1", "chr2"}
    return got


def test_stream_equals_runner_plus_predictor(paths, model):
    """The port's stream against its own staged pieces, with one worker
    and a predictor factory; options passed as a dict."""
    predictor = plan.PlanPredictor(
        model, wgs_options(PORT, paths).pileup_options, batch_size=BATCH,
        device="cpu", dtype=torch.float32)
    options = wgs_options(PORT, paths, regions=["chr2:200-1,100"])
    import dataclasses

    as_dict = {f.name: getattr(options, f.name)
               for f in dataclasses.fields(options)}
    cvos, stats, _ = sp.stream_examples_to_cvos(
        as_dict, 1, device_encode=True, device="cpu",
        plan_predictor_factory=lambda: predictor)
    from deepvariant_tpu_torch.make_examples import core as tcore

    planned = []
    tcore.make_examples_runner(options, plan_sink=planned.append)
    assert len(cvos) == len(planned) > 5
    want = np.concatenate([predictor([p.plan for p in planned[i:i + BATCH]])
                           for i in range(0, len(planned), BATCH)])
    for cvo, rec, probs in zip(cvos, planned, want):   # one worker: in order
        assert cvo.variant.encode() == rec.variant.encode()
        assert cvo.alt_allele_indices == rec.alt_indices
        np.testing.assert_allclose(cvo.genotype_probabilities, probs,
                                   atol=1e-6)


def test_device_defaults_to_the_card_and_a_missing_card_raises(paths, model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        sp.stream_examples_to_cvos(wgs_options(PORT, paths), 2, model=model,
                                   device_encode=True)


def test_unported_modes_raise(paths, model, tmp_path):
    """Host-encode streaming is ported: workers paint tf.Examples and the
    parent classifies their images with `Predictor`, built from `model`
    or by `predictor_factory` from the first image's shape, gVCF records
    included; the CVOs equal the device-encode stream's (the same images,
    float32; 1e-6). The JAX package's flax `variables` are not taken."""
    options = wgs_options(PORT, paths, regions=["chr2:200-1,100"])
    device_cvos, _, device_gvcfs = sp.stream_examples_to_cvos(
        options, 2, model=model, batch_size=BATCH, device_encode=True,
        device="cpu", dtype=torch.float32, want_gvcf=True)
    host_cvos, stats, host_gvcfs = sp.stream_examples_to_cvos(
        options, 2, model=model, batch_size=BATCH, device="cpu",
        dtype=torch.float32, want_gvcf=True)
    assert not stats.device_encode and stats.num_cvos == len(host_cvos) > 5
    assert sorted(v.encode() for v in host_gvcfs) == \
        sorted(v.encode() for v in device_gvcfs)
    shapes = []

    def factory(shape):
        from deepvariant_tpu_torch.calling.call_variants import Predictor

        shapes.append(shape)
        return Predictor(model, batch_size=BATCH, device="cpu",
                         dtype=torch.float32)

    factory_cvos, _, gvcfs = sp.stream_examples_to_cvos(
        options, 1, device="cpu", predictor_factory=factory)
    assert shapes == [(100, 221, 7)] and gvcfs is None
    for cvos in (host_cvos, factory_cvos):
        got, want = sorted(cvos, key=locus), sorted(device_cvos, key=locus)
        assert [locus(c) for c in got] == [locus(c) for c in want]
        for g, w in zip(got, want):
            assert g.variant.encode() == w.variant.encode()
            np.testing.assert_allclose(g.genotype_probabilities,
                                       w.genotype_probabilities, atol=1e-6)
    with pytest.raises(TypeError, match="variables"):
        sp.stream_examples_to_cvos(options, 2, variables={}, device="cpu")
    with pytest.raises(ValueError, match="predictor_factory or model"):
        sp.stream_examples_to_cvos(options, 2, device="cpu")
    with pytest.raises(ValueError, match="plan_predictor_factory or model"):
        sp.stream_examples_to_cvos(options, 2, device="cpu",
                                   device_encode=True)
    result = sp.run_streaming_pipeline(
        options, str(tmp_path / "out.vcf"), paths["ref"], model=model,
        num_workers=1, batch_size=BATCH, device="cpu", dtype=torch.float32)
    assert result["stream_device_encode"] is False
    assert result["postprocess"]["vcf_records"] > 3


def test_a_failing_worker_fails_the_stream(paths, model):
    """An unported option reaches the worker, which refuses it; the
    stream raises with the worker's message instead of hanging."""
    options = wgs_options(PORT, paths, regions=["chr2:200-600"])
    options.denovo_regions = ["chr2:1-10"]
    with pytest.raises(RuntimeError, match="de novo regions"):
        sp.stream_examples_to_cvos(options, 2, model=model, batch_size=BATCH,
                                   device_encode=True, device="cpu",
                                   dtype=torch.float32)


def test_stats_fields_match_jax():
    import dataclasses

    from deepvariant_tpu.parallel import stream_pipeline as jsp

    assert [f.name for f in dataclasses.fields(sp.StreamStats)] == \
        [f.name for f in dataclasses.fields(jsp.StreamStats)]
    assert sp._FLUSH_EVERY == jsp._FLUSH_EVERY

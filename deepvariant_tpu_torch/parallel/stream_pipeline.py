"""Fused streaming pipeline: reads file -> candidates -> card -> CVOs.

Counterpart of `deepvariant_tpu/parallel/stream_pipeline.py` (the
product equivalent of the reference's fast_pipeline binary,
fast_pipeline.cc:248): N make_examples worker PROCESSES (spawned, host
only; they never initialise CUDA) push payloads through a
multiprocessing queue into the parent process. Two encode modes:

  * device encode: workers stop after row PLANNING and ship compact
    PlannedExample payloads; the parent paints every pileup on the card
    (one launch of the CUDA paint kernel's plan form per batch) and runs
    the CNN on the painted batch without the image leaving device memory
    (calling.plan_predictor.PlanPredictor).
  * host encode: workers paint the pileups (pileup.build_pileup) and
    ship serialized tf.Examples; the parent batches their images into
    the CNN (calling.call_variants.Predictor).

CallVariantsOutputs accumulate in memory; no file lies between the
stages. gVCF records and the small model's CVOs stream through the same
queue (replacing their TFRecords), so `output_gvcf` and the options'
`call_small_model_examples` are drop-in equivalents of the staged gVCF
and small-model CVO file.

The CVOs equal the staged path's: workers iterate exactly the regions
their task_id owns (the round-robin rule of make_examples_core.py:881),
the plan painter is bit-exact against the host painter, and per-example
probabilities do not depend on batch boundaries.

`run_streaming_pipeline` goes on to the VCF and the gVCF:
`postprocess_variants` (stage 3, on the host) on the CVOs and the gVCF
records in memory; the small model's CVOs join the stream's CVOs before
it, as the staged path joins the two CVO files.
"""

from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import time
from typing import Dict, Iterator, List, Optional, Union

import torch

_SENTINEL_KIND = "done"
_BATCH_KIND = "examples"
_PLAN_KIND = "plans"
_GVCF_KIND = "gvcfs"
_SM_CVO_KIND = "small_model_cvos"
_FLUSH_EVERY = 64
_GVCF_FLUSH_EVERY = 512


def _stream_worker(options, task_id: int, num_shards: int,
                   out_queue: "mp.Queue", device_encode: bool = False,
                   want_gvcf: bool = False) -> None:
    """One make_examples shard, payloads to the queue (spawn target):
    plans with `device_encode`, serialized tf.Examples without, with
    `want_gvcf` encoded gVCF records, and with the options'
    `call_small_model_examples` the small model's encoded CVOs. Runs on
    the host only.

    `options` is a pickled MakeExamplesOptions (or a kwargs dict):
    passing the object keeps the streamed path's configuration
    identical to the staged path's, preset side-effects included.
    """
    from deepvariant_tpu_torch.calling.plan_predictor import compact_plan
    from deepvariant_tpu_torch.make_examples.core import (
        MakeExamplesOptions,
        make_examples_runner,
    )

    # One intra-op thread per worker: the planners are numpy and Python,
    # and N workers with a full torch pool each would fight for cores.
    torch.set_num_threads(1)
    try:
        if isinstance(options, dict):
            options = MakeExamplesOptions(**options)
        options.task_id = task_id
        options.num_shards = num_shards
        options.examples_filename = ""  # the sink replaces every TFRecord
        options.gvcf_filename = ""
        options.small_model_cvo_filename = ""

        bufs: Dict[str, list] = {_BATCH_KIND: [], _PLAN_KIND: [],
                                 _GVCF_KIND: [], _SM_CVO_KIND: []}

        def flush(kind: str):
            if bufs[kind]:
                out_queue.put((kind, bufs[kind][:]))
                bufs[kind].clear()

        def make_sink(kind: str, every: int = _FLUSH_EVERY):
            def sink(item):
                bufs[kind].append(item)
                if len(bufs[kind]) >= every:
                    flush(kind)
            return sink

        sinks = {}
        if device_encode:
            diff = options.pileup_options.alt_aligned_pileup == \
                "diff_channels"
            sink_plan = make_sink(_PLAN_KIND)

            def plan_sink(planned):
                planned.plan = compact_plan(planned.plan, diff)
                sink_plan(planned)

            sinks["plan_sink"] = plan_sink
        else:
            sinks["example_sink"] = make_sink(_BATCH_KIND)
        if want_gvcf:
            # Variants cross the spawn boundary as their encoded bytes.
            gvcf_sink = make_sink(_GVCF_KIND, _GVCF_FLUSH_EVERY)
            sinks["gvcf_sink"] = lambda v: gvcf_sink(v.encode())
        if options.call_small_model_examples:
            sm_cvo_sink = make_sink(_SM_CVO_KIND)
            sinks["small_model_cvo_sink"] = \
                lambda cvo: sm_cvo_sink(cvo.encode())
        counts = make_examples_runner(options, **sinks)
        for kind in bufs:
            flush(kind)
        if torch.cuda.is_initialized():
            raise RuntimeError("a stream worker initialised CUDA; workers "
                               "run on the host only")
        out_queue.put((_SENTINEL_KIND, task_id, counts, None))
    except BaseException as e:  # surfaced in the parent process
        out_queue.put((_SENTINEL_KIND, task_id, {}, repr(e)))
        raise


@dataclasses.dataclass
class StreamStats:
    num_examples: int = 0
    num_cvos: int = 0
    wall_seconds: float = 0.0
    examples_per_sec: float = 0.0
    stage1_counts: Optional[Dict[int, Dict[str, int]]] = None
    device_encode: bool = False
    num_small_model_cvos: int = 0
    num_gvcf_records: int = 0
    # Rate from the first classified batch on: the predictor's set-up
    # (weights to the card, cuDNN's first-call work) is a per-process
    # constant, not per-genome work.
    steady_state_examples_per_sec: float = 0.0


def stream_examples_to_cvos(
    options,
    num_workers: int,
    variables=None,
    model=None,
    batch_size: int = 512,
    queue_capacity: int = 64,
    predictor_factory=None,
    device_encode: bool = False,
    plan_predictor_factory=None,
    want_gvcf: bool = False,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> tuple:
    """Run the fused stage-1+2: returns (cvos, StreamStats, gvcfs).

    Workers produce payloads concurrently with inference; the measured
    examples/sec INCLUDES the host feed (BAM decoding, candidate
    generation, planning or painting, host->device transfer).

    Device-encode mode (`device_encode=True`): workers ship plans, and
    either `plan_predictor_factory()` returns a
    calling.plan_predictor.PlanPredictor on `device`, or `model` (an
    InceptionV3 module with its weights loaded) is given and the
    PlanPredictor is built here from the options' pileup options.
    Host-encode mode: workers ship painted tf.Examples, and either
    `predictor_factory(shape)` builds a calling.call_variants.Predictor
    on `device` from the first streamed example's (H, W, C), or `model`
    is given and the Predictor is built here. Either predictor built
    here takes `batch_size`, `device` and `dtype`. `device` defaults to
    the card, and a missing card raises before any worker starts.
    `variables` (the JAX package's flax tree) is not taken: the port's
    weights live in the model (models.checkpoint reads flax files).

    The third element of the result is the gVCF records (Variants, in
    the order the workers sent them) with `want_gvcf`, else None. With
    the options' `call_small_model_examples` the small model's CVOs
    follow the CNN's in the first element, as in the JAX package
    (stage 3 sorts them by locus either way).
    """
    from deepvariant_tpu_torch.calling.call_variants import (
        ExampleRecord,
        Predictor,
        round_gls,
    )
    from deepvariant_tpu_torch.calling.plan_predictor import PlanPredictor
    from deepvariant_tpu_torch.core.types import CallVariantsOutput, Variant
    from deepvariant_tpu_torch.device import resolve_device
    from deepvariant_tpu_torch.io import examples as example_codec

    if variables is not None:
        raise TypeError(
            "the port's stream takes `model` (an InceptionV3 with its "
            "weights) or a predictor factory, not flax `variables`")
    if device_encode and plan_predictor_factory is None and model is None:
        raise ValueError(
            "device_encode=True needs plan_predictor_factory or model"
        )
    if not device_encode and predictor_factory is None and model is None:
        raise ValueError("host encoding needs predictor_factory or model")
    device = resolve_device(device)
    pileup_options = (
        options["pileup_options"] if isinstance(options, dict)
        else options.pileup_options
    )

    ctx = mp.get_context("spawn")  # never fork a live CUDA context
    out_queue: "mp.Queue" = ctx.Queue(maxsize=queue_capacity)
    workers = []
    for task in range(num_workers):
        proc = ctx.Process(
            target=_stream_worker,
            args=(options, task, num_workers, out_queue, device_encode,
                  want_gvcf),
            daemon=True,
        )
        proc.start()
        workers.append(proc)

    t0 = time.time()
    stage1_counts: Dict[int, Dict[str, int]] = {}
    failures: List[str] = []
    first_result_t: List[float] = []
    gvcf_records: Optional[List] = [] if want_gvcf else None
    small_model_cvos: List = []

    def payloads() -> Iterator:
        remaining = num_workers
        while remaining:
            msg = out_queue.get()
            if msg[0] == _SENTINEL_KIND:
                _, task_id, counts, err = msg
                if err is not None:
                    failures.append(f"worker {task_id}: {err}")
                    for p in workers:
                        p.terminate()
                    return
                stage1_counts[task_id] = counts
                remaining -= 1
                continue
            if msg[0] == _GVCF_KIND:
                gvcf_records.extend(Variant.decode(buf) for buf in msg[1])
                continue
            if msg[0] == _SM_CVO_KIND:
                small_model_cvos.extend(
                    CallVariantsOutput.decode(buf) for buf in msg[1])
                continue
            if msg[0] == _PLAN_KIND:
                yield from msg[1]
                continue
            for serialized in msg[1]:
                ex = example_codec.parse_example(serialized)
                yield ExampleRecord(
                    image=ex.image,
                    variant=ex.variant,
                    alt_allele_indices=ex.alt_allele_indices,
                    label=ex.label,
                )

    def on_device(built, factory: str):
        if built.device.type != device.type:
            raise ValueError(
                f"{factory} built a predictor on {built.device}, the "
                f"stream was asked for {device}")

    def classified():
        rec_iter = payloads()
        if device_encode:
            if plan_predictor_factory is not None:
                predictor = plan_predictor_factory()
                on_device(predictor.predictor, "plan_predictor_factory")
            else:
                predictor = PlanPredictor(
                    model, pileup_options, batch_size=batch_size,
                    device=device, dtype=dtype)
            yield from predictor.predict_plan_stream(rec_iter)
            return
        first = next(rec_iter, None)
        if first is None:
            return
        if predictor_factory is not None:
            predictor = predictor_factory(first.image.shape)
            on_device(predictor, "predictor_factory")
        else:
            predictor = Predictor(model, batch_size=batch_size,
                                  device=device, dtype=dtype)
        yield from predictor.predict_stream(
            itertools.chain([first], rec_iter))

    cvos: List[CallVariantsOutput] = []
    try:
        for rec, probs in classified():
            if not first_result_t:
                first_result_t.append(time.time())
            cvos.append(CallVariantsOutput(
                variant=rec.variant,
                alt_allele_indices=(
                    rec.alt_indices if device_encode
                    else rec.alt_allele_indices
                ),
                genotype_probabilities=round_gls(
                    [float(p) for p in probs]
                ),
            ))
    except BaseException:
        for p in workers:
            p.terminate()
        raise
    finally:
        for p in workers:
            p.join(timeout=30)
    if failures:
        raise RuntimeError(
            "streaming make_examples failed: " + "; ".join(failures)
        )
    dt = max(time.time() - t0, 1e-9)
    steady = 0.0
    if first_result_t and len(cvos) > 1:
        # The first result absorbs the predictor's set-up; rate over
        # the rest.
        steady_dt = max(time.time() - first_result_t[0], 1e-9)
        steady = (len(cvos) - 1) / steady_dt
    stats = StreamStats(
        num_examples=sum(
            c.get("examples", 0) for c in stage1_counts.values()
        ),
        num_cvos=len(cvos),
        wall_seconds=dt,
        examples_per_sec=len(cvos) / dt,
        stage1_counts=stage1_counts,
        device_encode=device_encode,
        num_small_model_cvos=len(small_model_cvos),
        num_gvcf_records=len(gvcf_records) if want_gvcf else 0,
        steady_state_examples_per_sec=steady,
    )
    if stats.num_examples != stats.num_cvos:
        raise RuntimeError(
            f"stream lost examples: workers produced "
            f"{stats.num_examples}, classified {stats.num_cvos}"
        )
    cvos.extend(small_model_cvos)
    return cvos, stats, gvcf_records


def run_streaming_pipeline(
    options,
    output_vcf: str,
    ref_path: str,
    variables=None,
    model=None,
    sample_name: str = "default",
    num_workers: int = 2,
    batch_size: int = 512,
    postprocess_kwargs: Optional[Dict] = None,
    predictor_factory=None,
    device_encode: bool = False,
    plan_predictor_factory=None,
    output_gvcf: str = "",
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """Full fused run: reads file -> streamed payloads -> card -> VCF
    (+gVCF).

    `stream_examples_to_cvos` (either encode mode; `device` and `dtype`
    as there: the card by default, and a missing card raises), then
    `postprocess_variants` on the CVOs in memory, on the host; with
    `output_gvcf` it merges the streamed gVCF records in, truncated
    blocks taking their first base from the FASTA. An output ending in
    `.gz` is BGZF; its tabix index is the caller's
    (`io.tabix.build_index`), as in the JAX package."""
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.postprocess.pipeline import (
        fasta_ref_lookup,
        postprocess_variants,
    )

    cvos, stats, gvcf_records = stream_examples_to_cvos(
        options, num_workers, variables,
        model=model, batch_size=batch_size,
        predictor_factory=predictor_factory,
        device_encode=device_encode,
        plan_predictor_factory=plan_predictor_factory,
        want_gvcf=bool(output_gvcf),
        device=device, dtype=dtype,
    )
    ref_reader = FastaReader(ref_path)
    pp_kwargs = dict(postprocess_kwargs or {})
    if output_gvcf:
        # One base, as the postprocess CLI looks it up. (The JAX package
        # passes `ref_reader.bases` here, which takes a Range and raises
        # at the first block a variant truncates.)
        pp_kwargs.update(
            nonvariant_site_path=gvcf_records,
            output_gvcf=output_gvcf,
            ref_lookup=fasta_ref_lookup(ref_reader),
        )
    pp = postprocess_variants(
        cvos, output_vcf, ref_reader.contigs, sample_name=sample_name,
        **pp_kwargs,
    )
    return {
        "stream_examples": stats.num_examples,
        "stream_examples_per_sec": round(stats.examples_per_sec, 2),
        "stream_steady_state_examples_per_sec": round(
            stats.steady_state_examples_per_sec, 2
        ),
        "stream_wall_seconds": round(stats.wall_seconds, 3),
        "stream_device_encode": device_encode,
        "stream_small_model_cvos": stats.num_small_model_cvos,
        "stream_gvcf_records": stats.num_gvcf_records,
        "postprocess": pp,
    }

"""One-step pipeline driver (reference scripts/run_deepvariant.py:863).

The port's copy of `deepvariant_tpu.scripts.run_deepvariant`, with the
same flags plus two: `--make_examples_extra_args` (the reference's flag,
a comma-separated `flag=value` list appended to every make_examples
shard's flags, as the JAX package's run_oracle_inference takes it) and
`--device` (default `cuda`; a missing card raises, `--device cpu` runs
stage 2 and the stream's CNN on the CPU in float32).
Runs the three stages in sequence:
  make_examples (N shard processes, replacing GNU parallel,
  run_deepvariant.py:457-462; spawned, host only, so none touches CUDA)
  -> call_variants (one process, batched inference on `--device`, after
  stage 1's pool has closed) -> postprocess_variants (host, with the
  gVCF under --output_gvcf).
`--stream` runs the fused streaming pipeline instead, with no example or
CVO files: the pileups are painted on the card from plans where the
preset's channels allow it (`--stream_encoder auto|device`), or painted
by the workers on the host (`--stream_encoder host`, or a channel list
the plan painter lacks).

Model-type presets select pileup channels per product
(run_deepvariant.py:483-491); WGS/WES use the 7-channel default
(6 base channels + insert_size).

Run: python -m deepvariant_tpu_torch.scripts.run_deepvariant \\
       --ref ref.fa --reads reads.bam --output_vcf out.vcf.gz \\
       --output_gvcf out.g.vcf.gz --checkpoint dir --num_shards 2
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import re
import sys
import time

MODEL_TYPES = (
    "WGS",
    "WES",
    "PACBIO",
    "ONT_R104",
    "HYBRID_PACBIO_ILLUMINA",
    "MASSEQ",
    "RNASEQ",
)


def split_extra_args(input_string: str) -> list:
    """Split on commas except inside quoted values
    (run_oracle_inference.py:213-216)."""
    pattern = r"[^,]+=[\"'][^\"']*[\"']|[^,]+"
    return re.findall(pattern, input_string)


def extra_args_to_argv(extra_args: str) -> list:
    """A comma-separated flag_name=flag_value list as make_examples argv
    fragments; true and false map to --flag and --no-flag."""
    argv = []
    if not extra_args:
        return argv
    for item in split_extra_args(extra_args):
        name, value = item.split("=", 1)
        name = name.strip().lstrip("-")
        value = value.strip().strip("\"'")
        if value.lower() == "true":
            argv.append(f"--{name}")
        elif value.lower() == "false":
            argv.append(f"--no-{name}")
        else:
            argv += [f"--{name}", value]
    return argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_deepvariant")
    p.add_argument("--model_type", choices=MODEL_TYPES, default="WGS")
    p.add_argument("--ref", required=True)
    p.add_argument("--reads", required=True)
    p.add_argument("--output_vcf", required=True)
    p.add_argument("--output_gvcf", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--regions", default=None)
    p.add_argument("--sample_name", default="default")
    p.add_argument("--intermediate_results_dir", default="")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--allow_uninitialized_model", action="store_true")
    p.add_argument("--writer_threads", type=int, default=0,
                   help="CVO writer processes for stage 2 "
                   "(0 = autodetect; reference run_deepvariant.py "
                   "--call_variants_extra_args writer_threads)")
    p.add_argument("--realign_reads",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--channel_list", default="",
                   help="override the preset's pileup channel set")
    p.add_argument("--enable_methylation_calling", action="store_true")
    p.add_argument("--enable_methylation_aware_phasing",
                   action="store_true")
    p.add_argument("--use_multiallelic_model", action="store_true")
    p.add_argument("--call_small_model_examples", action="store_true")
    p.add_argument("--trained_small_model_path", default="")
    p.add_argument(
        "--stream", action="store_true",
        help="fused streaming pipeline: make_examples workers feed "
             "candidate payloads straight into inference and "
             "postprocess with NO intermediate example/CVO files "
             "(the reference's fast_pipeline equivalent, "
             "fast_pipeline.cc:248)")
    p.add_argument(
        "--stream_encoder", choices=("auto", "device", "host"),
        default="auto",
        help="--stream pileup painter: 'device' paints the pileups on "
             "the card from compact candidate plans (the CUDA paint "
             "kernel), 'host' paints images on the workers; 'auto' "
             "picks device whenever the preset's channels allow it")
    p.add_argument("--make_examples_extra_args", default=None,
                   help="comma-separated flag=value list for every "
                        "make_examples shard, e.g. "
                        "output_local_read_phasing=dir/phase@2.tsv")
    p.add_argument("--device", default="cuda",
                   help="where stage 2 and the stream's CNN run: cuda "
                        "(default; fails without a card) or cpu")
    return p


def _run_make_examples_shard(args_tuple):
    import io
    from contextlib import redirect_stdout

    from deepvariant_tpu_torch.scripts.make_examples import main as me_main

    argv, task = args_tuple
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = me_main(argv + ["--task", str(task)])
    return rc, buf.getvalue()


def _stream_device_encodable(options) -> bool:
    """Is the preset's pileup config paintable by the plan painter on
    the card (pileup_device.make_longread_encode_fn)?"""
    from deepvariant_tpu_torch.make_examples.examples_builder import (
        ExamplesBuilder,
    )

    return ExamplesBuilder(
        None, options.pileup_options).supports_device_encode()


def _run_stream(args, me_argv, num_workers: int, t_start: float,
                device) -> int:
    """Fused streaming mode: stage 1 workers feed the CNN directly; no
    intermediate example/CVO/gVCF files (fast_pipeline.cc:248 analog).
    Where the preset's channels allow it the pileup painting also moves
    onto the card: workers ship compact candidate plans, and each batch
    is painted by one launch of the CUDA paint kernel's plan form and
    classified without the image leaving device memory."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor
    from deepvariant_tpu_torch.parallel.stream_pipeline import (
        run_streaming_pipeline,
    )
    from deepvariant_tpu_torch.scripts.call_variants import (
        load_variables_for_shape,
    )
    from deepvariant_tpu_torch.scripts.make_examples import (
        build_parser as me_build_parser,
        resolved_options_from_args,
    )

    if not args.checkpoint and not args.allow_uninitialized_model:
        raise SystemExit(
            "pass --checkpoint (or --allow_uninitialized_model for "
            "testing)"
        )
    me_args = me_build_parser().parse_args(me_argv + ["--task", "0"])
    options = resolved_options_from_args(me_args)

    device_encode = args.stream_encoder != "host" and \
        _stream_device_encodable(options)
    if args.stream_encoder == "device" and not device_encode:
        raise SystemExit(
            "--stream_encoder=device: this preset's channel/alt-mode "
            "configuration is not device-encodable; use "
            "--stream_encoder=host or auto"
        )
    # float32 on the CPU, bfloat16 on the card, as the call_variants CLI.
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16

    plan_predictor_factory = None
    predictor_factory = None
    if device_encode:
        o = options.pileup_options
        c = len(o.channels) + (
            2 if o.alt_aligned_pileup == "diff_channels" else 0
        )
        shape = (o.height, o.width, c)

        def plan_predictor_factory():
            from deepvariant_tpu_torch.calling.plan_predictor import (
                PlanPredictor,
            )

            model = load_variables_for_shape(
                args.checkpoint, shape, device=device
            )
            return PlanPredictor(
                model, o, batch_size=args.batch_size, device=device,
                dtype=dtype,
            )
    else:
        def predictor_factory(shape):
            model = load_variables_for_shape(
                args.checkpoint, shape, device=device
            )
            return Predictor(
                model, batch_size=args.batch_size, device=device,
                dtype=dtype,
            )

    result = run_streaming_pipeline(
        options,
        args.output_vcf,
        args.ref,
        sample_name=args.sample_name,
        num_workers=num_workers,
        batch_size=args.batch_size,
        predictor_factory=predictor_factory,
        device_encode=device_encode,
        plan_predictor_factory=plan_predictor_factory,
        output_gvcf=args.output_gvcf,
        postprocess_kwargs={
            "use_multiallelic_model": args.use_multiallelic_model,
        },
        device=device,
        dtype=dtype,
    )
    print(
        f"streamed {result['stream_examples']} examples at "
        f"{result['stream_examples_per_sec']} ex/s (feed included; "
        f"steady-state "
        f"{result['stream_steady_state_examples_per_sec']} ex/s), "
        f"encoder={'device' if device_encode else 'host'}; "
        f"postprocess: {result['postprocess']}"
    )
    print(f"total: {time.time() - t_start:.1f}s -> {args.output_vcf}")
    return 0


def main(argv=None) -> int:
    from deepvariant_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    t_start = time.time()
    # Refuse a missing card before stage 1 runs; the card itself is
    # first touched by stage 2 (or the stream's CNN), in this process.
    device = resolve_device(args.device)
    outdir = args.intermediate_results_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.output_vcf)),
        "intermediate_results_dir",
    )
    os.makedirs(outdir, exist_ok=True)
    n = max(args.num_shards, 1)
    examples_spec = os.path.join(
        outdir, f"make_examples.tfrecord@{n}.gz"
    )
    gvcf_spec = os.path.join(
        outdir, f"gvcf.tfrecord@{n}.gz"
    ) if args.output_gvcf else ""
    cvo_path = os.path.join(outdir, "call_variants_output.tfrecord.gz")

    # Stage 1: make_examples, sharded across processes.
    me_argv = [
        "--mode", "calling",
        "--ref", args.ref,
        "--reads", args.reads,
        "--examples", examples_spec,
        "--num_shards", str(n),
        "--sample_name", args.sample_name,
        "--model_preset", args.model_type,
    ]
    if gvcf_spec:
        me_argv += ["--gvcf", gvcf_spec]
    if args.regions:
        me_argv += ["--regions", args.regions]
    if not args.realign_reads:
        me_argv += ["--no-realign_reads"]
    if args.channel_list:
        me_argv += ["--channel_list", args.channel_list]
    if args.enable_methylation_calling:
        me_argv += ["--enable_methylation_calling"]
    if args.enable_methylation_aware_phasing:
        me_argv += ["--enable_methylation_aware_phasing"]
    small_model_cvo_spec = ""
    if args.call_small_model_examples:
        small_model_cvo_spec = os.path.join(
            outdir, f"small_model_cvos.tfrecord@{n}.gz"
        )
        me_argv += ["--call_small_model_examples",
                    "--small_model_cvo_records", small_model_cvo_spec]
        if args.trained_small_model_path:
            me_argv += ["--trained_small_model_path",
                        args.trained_small_model_path]
    me_argv += extra_args_to_argv(args.make_examples_extra_args)
    if args.stream:
        return _run_stream(args, me_argv, n, t_start, device)
    t0 = time.time()
    if n == 1:
        rc, out = _run_make_examples_shard((me_argv, 0))
        print(out, end="")
        if rc != 0:
            return rc
    else:
        # Halt-on-first-failure semantics (the reference fans out with
        # GNU parallel --halt 2, run_deepvariant.py:457-462): the first
        # shard returning nonzero terminates the remaining shards
        # instead of letting them run the full stage. The shards are
        # spawned: a forked child would inherit whatever CUDA state this
        # process holds.
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(n) as pool:
            failed_rc = 0
            for rc, out in pool.imap_unordered(
                _run_make_examples_shard,
                [(me_argv, task) for task in range(n)],
            ):
                print(out, end="")
                if rc != 0:
                    failed_rc = rc
                    pool.terminate()
                    break
        if failed_rc != 0:
            print(
                f"make_examples shard failed (rc={failed_rc}); "
                "halting remaining shards"
            )
            return failed_rc
    print(f"stage 1 (make_examples x{n}): {time.time() - t0:.1f}s")

    # Stage 2: call_variants.
    from deepvariant_tpu_torch.scripts.call_variants import main as cv_main

    cv_argv = [
        "--examples", examples_spec,
        "--outfile", cvo_path,
        "--batch_size", str(args.batch_size),
        "--writer_threads", str(args.writer_threads),
        "--device", args.device,
    ]
    if args.checkpoint:
        cv_argv += ["--checkpoint", args.checkpoint]
    elif args.allow_uninitialized_model:
        cv_argv += ["--allow_uninitialized_model"]
    t0 = time.time()
    rc = cv_main(cv_argv)
    if rc != 0:
        return rc
    print(f"stage 2 (call_variants): {time.time() - t0:.1f}s")

    # Stage 3: postprocess_variants.
    from deepvariant_tpu_torch.scripts.postprocess_variants import (
        main as pp_main,
    )

    pp_argv = [
        "--ref", args.ref,
        "--infile", cvo_path,
        "--outfile", args.output_vcf,
        "--sample_name", args.sample_name,
    ]
    if args.use_multiallelic_model:
        pp_argv += ["--use_multiallelic_model"]
    if small_model_cvo_spec:
        pp_argv += ["--small_model_cvo_records", small_model_cvo_spec]
    if args.output_gvcf:
        pp_argv += [
            "--nonvariant_site_tfrecord_path", gvcf_spec,
            "--gvcf_outfile", args.output_gvcf,
        ]
    t0 = time.time()
    rc = pp_main(pp_argv)
    if rc != 0:
        return rc
    print(f"stage 3 (postprocess_variants): {time.time() - t0:.1f}s")
    print(f"total: {time.time() - t_start:.1f}s -> {args.output_vcf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-step DeepSomatic pipeline (reference scripts/run_deepsomatic.py).

The port's copy of the JAX package's one-step script, with its flags plus
`--device`. Tumor/normal (or tumor-only) somatic calling: somatic
make_examples on the host ([normal, tumor] stack, tumor candidates)
-> call_variants on `--device` (default
`cuda`; a missing card raises before make_examples starts, `--device
cpu` runs on the CPU in float32) -> postprocess_variants with
--process_somatic (and --pon_filtering). The somatic caller runs with
min_fraction_multiplier=inf (make_examples_somatic.py:149: candidates
come from the tumor sample alone, no pooled rescue).

Refused, because the JAX script accepts them and they change nothing:
`--num_shards` at any value but 1, `--model_type` at any value but WGS
(both read nowhere), and `--filter_low_vaf_candidates` (the tumor-only
route runs the single-sample make_examples, which does not filter; the
tumor/normal route counts no reference reads, so every candidate's VAF
is 1 and the filter drops none).

Run: python -m deepvariant_tpu_torch.scripts.run_deepsomatic --ref ref.fa \
       --reads_tumor t.bam --reads_normal n.bam --output_vcf s.vcf.gz \
       --checkpoint dir [--pon_filtering pon.vcf.gz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

MODEL_TYPES = ("WGS", "WES", "PACBIO", "ONT", "FFPE_WGS", "FFPE_WES",
               "WGS_TUMOR_ONLY", "PACBIO_TUMOR_ONLY", "ONT_TUMOR_ONLY")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_deepsomatic")
    p.add_argument("--model_type", choices=MODEL_TYPES, default="WGS")
    p.add_argument("--ref", required=True)
    p.add_argument("--reads_tumor", required=True)
    p.add_argument("--reads_normal", default="",
                   help="omit for tumor-only calling")
    p.add_argument("--sample_name_tumor", default="tumor")
    p.add_argument("--sample_name_normal", default="normal")
    p.add_argument("--output_vcf", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--regions", default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--intermediate_results_dir", default="")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--allow_uninitialized_model", action="store_true")
    p.add_argument("--pon_filtering", default="",
                   help="Panel-of-Normals VCF; matching PASS variants "
                        "get the PON filter")
    p.add_argument("--filter_low_vaf_candidates",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


# The flags the JAX script accepts and reads nowhere, with the only value
# the port takes.
UNREAD_FLAGS = {"num_shards": 1, "model_type": "WGS"}


def main(argv=None) -> int:
    from deepvariant_tpu_torch.device import resolve_device
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.multisample import (
        make_multisample_examples_runner,
        refuse_unread_flags,
        somatic_samples,
    )
    from deepvariant_tpu_torch.scripts.call_variants import main as cv_main
    from deepvariant_tpu_torch.scripts.postprocess_variants import (
        main as pp_main,
    )

    args = build_parser().parse_args(argv)
    refuse_unread_flags(args, UNREAD_FLAGS)
    if args.filter_low_vaf_candidates:
        raise NotImplementedError(
            "--filter_low_vaf_candidates: the JAX script's tumor-only route "
            "runs the single-sample make_examples, which reads the flag "
            "nowhere, and its tumor/normal route runs without "
            "track_ref_reads, so no candidate has reference support, every "
            "VAF is 1 and none is filtered; ROADMAP.md Queue 3 (unread "
            "product-driver options)")
    # Refuse a missing card before stage 1 runs.
    resolve_device(args.device)
    t_start = time.time()
    outdir = args.intermediate_results_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.output_vcf)),
        "intermediate_results_dir",
    )
    os.makedirs(outdir, exist_ok=True)
    examples = os.path.join(outdir, "make_examples_somatic.tfrecord.gz")

    options = MakeExamplesOptions(
        reads_filename=args.reads_tumor,
        ref_filename=args.ref,
        examples_filename=examples,
        mode="calling",
        regions=args.regions.split() if args.regions else None,
        sample_name=args.sample_name_tumor,
        filter_low_vaf_candidates=args.filter_low_vaf_candidates,
    )
    # Somatic: no pooled-sample rescue (make_examples_somatic.py:149).
    options.variant_caller_options.min_fraction_multiplier = float("inf")
    options.pileup_options.channels = (1, 2, 3, 4, 5, 6, 19)

    t0 = time.time()
    if args.reads_normal:
        samples = somatic_samples(
            args.reads_tumor, args.reads_normal,
            args.sample_name_tumor, args.sample_name_normal,
        )
        counts = make_multisample_examples_runner(
            options, samples, main_sample_index=1
        )
    else:
        from deepvariant_tpu_torch.make_examples.core import (
            make_examples_runner,
        )

        options.variant_caller_options.min_fraction_multiplier = 1.0
        counts = make_examples_runner(options)
    print(f"make_examples: {counts} ({time.time() - t0:.1f}s)")

    cvo = os.path.join(outdir, "cvo_somatic.tfrecord.gz")
    cv_argv = ["--examples", examples, "--outfile", cvo,
               "--batch_size", str(args.batch_size),
               "--device", args.device]
    if args.checkpoint:
        cv_argv += ["--checkpoint", args.checkpoint]
    elif args.allow_uninitialized_model:
        cv_argv += ["--allow_uninitialized_model"]
    rc = cv_main(cv_argv)
    if rc != 0:
        return rc

    pp_argv = [
        "--ref", args.ref,
        "--infile", cvo,
        "--outfile", args.output_vcf,
        "--sample_name", args.sample_name_tumor,
        "--process_somatic",
    ]
    if args.pon_filtering:
        pp_argv += ["--pon_filtering", args.pon_filtering]
    rc = pp_main(pp_argv)
    if rc != 0:
        return rc
    print(f"total: {time.time() - t_start:.1f}s -> {args.output_vcf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Resume a DeepSomatic eval from cached stage-1 artifacts.

An eval whose CNN leg failed can restart HERE from the merged
calling/oracle TFRecords and the (deterministic) eval simulation's
truth files, skipping simulation and stage-1 entirely. Everything
from the CNN on matches accuracy_somatic.evaluate_model. The port's
copy of the JAX package's script, plus `--device` (default `cuda`,
which raises without a card; `cpu` runs float32).
"""

from __future__ import annotations

import argparse
import json
import os

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.scripts.accuracy_somatic import (
    CONTIG,
    EVAL_WINDOWS,
    GRCH38_10M,
    VAF_BINS,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("resume_somatic_eval")
    p.add_argument("--workdir", required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--report", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where call_variants runs; cuda raises without "
                        "a card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from deepvariant_tpu_torch.io import tfrecord
    from deepvariant_tpu_torch.io.examples import parse_example
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.vcf import VcfReader
    from deepvariant_tpu_torch.postprocess.pipeline import postprocess_variants
    from deepvariant_tpu_torch.scripts.accuracy_sim import call_checkpoint
    from deepvariant_tpu_torch.tools import vcf_eval

    ev_dir = os.path.join(args.workdir, "eval")
    sim_dir = os.path.join(ev_dir, "sim")
    ckpt = os.path.join(
        args.workdir, "experiment", "checkpoints", "final.msgpack"
    )
    calling_path = os.path.join(ev_dir, "calling.tfrecord.gz")
    oracle_path = os.path.join(ev_dir, "oracle.tfrecord.gz")
    truth_somatic = os.path.join(sim_dir, "truth_somatic.vcf.gz")
    truth_germline = os.path.join(sim_dir, "truth_germline.vcf.gz")
    bed = os.path.join(sim_dir, "confident.bed")

    # Reconstruct the sim-side truth views from the persisted VCFs.
    vaf_by_pos = {}
    somatic_pos = []
    with VcfReader(truth_somatic) as r:
        for v in r:
            somatic_pos.append(v.start)
            vaf_by_pos[v.start] = float(v.info["VAF"][0])
    with VcfReader(truth_germline) as r:
        germline_pos = {v.start for v in r}

    cvo_path = os.path.join(ev_dir, "cvo.tfrecord.gz")
    call_checkpoint(ckpt, calling_path, cvo_path, args.batch_size, device)
    vcf_out = os.path.join(ev_dir, "somatic.vcf.gz")
    postprocess_variants(
        cvo_path, vcf_out, FastaReader(GRCH38_10M).contigs,
        sample_name="tumor", process_somatic=True,
    )
    region = f"{CONTIG}:{EVAL_WINDOWS[0][0]}-{EVAL_WINDOWS[-1][1]}"
    model_metrics = vcf_eval.evaluate(
        truth_somatic, vcf_out, confident_bed=bed, region=region,
    )
    with VcfReader(vcf_out) as r:
        called = {
            (v.reference_name, v.start) for v in r
            if v.filter in (["PASS"], ["."])
            and v.calls and sorted(v.calls[0].genotype) == [1, 1]
        }
    reachable = set()
    for buf in tfrecord.read_tfrecords(oracle_path):
        ex = parse_example(buf)
        if int(ex.label or 0) == 2:
            reachable.add(ex.variant.start)

    strata = []
    for lo_v, hi_v in VAF_BINS:
        in_bin = [
            pos for pos in somatic_pos
            if lo_v <= vaf_by_pos[pos] < hi_v
        ]
        tp = sum(1 for pos in in_bin if (CONTIG, pos) in called)
        n_reach = sum(1 for pos in in_bin if pos in reachable)
        tp_reach = sum(
            1 for pos in in_bin
            if pos in reachable and (CONTIG, pos) in called
        )
        strata.append({
            "vaf_bin": [lo_v, hi_v],
            "n": len(in_bin),
            "called": tp,
            "recall": round(tp / len(in_bin), 4) if in_bin else None,
            "recall_ci95": [
                round(x, 4)
                for x in vcf_eval.wilson_ci(tp, len(in_bin))
            ],
            "candidate_reachable": n_reach,
            "ceiling_recall": (
                round(n_reach / len(in_bin), 4) if in_bin else None
            ),
            "recall_of_reachable": (
                round(tp_reach / n_reach, 4) if n_reach else None
            ),
        })
        print(f"VAF [{lo_v:.2f},{hi_v:.2f}): recall {tp}/"
              f"{len(in_bin)} (ceiling {n_reach}, of-reachable "
              f"{tp_reach}/{n_reach})")
    n_reachable = sum(1 for pos in somatic_pos if pos in reachable)
    called_reach = sum(
        1 for pos in somatic_pos
        if pos in reachable and (CONTIG, pos) in called
    )
    leaks = sum(1 for (c, pos) in called if pos in germline_pos)
    result = {
        "region": region,
        "model": model_metrics,
        "vaf_strata": strata,
        "candidate_ceiling_recall": round(
            n_reachable / len(somatic_pos), 4
        ),
        "candidate_reachable": n_reachable,
        "recall_of_reachable": (
            round(called_reach / n_reachable, 4)
            if n_reachable else None
        ),
        "germline_sites": len(germline_pos),
        "germline_leaks": leaks,
    }
    report = args.report or os.path.join(args.workdir, "report.json")
    with open(report, "w") as f:
        json.dump({"eval": result}, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

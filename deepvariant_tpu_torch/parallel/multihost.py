"""Multi-process pipeline execution over torch.distributed.

Counterpart of `deepvariant_tpu/parallel/multihost.py`. Every process
joins the group (`initialize_multihost`: explicit arguments, or the
variables torchrun sets), takes its region shard by the reference's
`i % num_shards == task_id` rule, runs stage 1 and classification over
its shard, writes its CVO shard, and joins an all-gather of the
per-process counts over the group, which doubles as the completion
barrier; rank 0 then merges every shard into one VCF.

    python -m deepvariant_tpu_torch.parallel.multihost --workdir w \
        --coordinator host:port --num_processes 2 --process_id 0 \
        --options_json '{...}' --regions_json '[...]' [--device cpu]

`--coordinator` also takes a URL such as `file:///shared/store`. Each
process computes on its own card (NCCL between cards); processes that
share a card, or the CPU (`--device cpu`), meet over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.parallel.distribute import (
    DEFAULT_TIMEOUT_S,
    all_gather_counts,
    data_parallel_mesh,
    host_shard_assignment,
    initialize_multihost,
    shutdown,
)


def gather_counts_across_hosts(
    local_count: int, device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """All-gather one int per process over the group. Doubles as a
    barrier: no process gets the counts until every process has given
    its own."""
    return all_gather_counts(local_count, data_parallel_mesh(device))


def _toy_probabilities(images: np.ndarray,
                       device: Union[str, torch.device]) -> np.ndarray:
    """Deterministic, data-dependent stand-in classifier for pipeline
    plumbing tests: a computation on the device over image statistics
    (the production path swaps in calling.call_variants.Predictor). The
    standard deviation divides by n, as jnp.std does."""
    x = torch.from_numpy(images).to(device).to(torch.float32) / 254.0
    feats = torch.stack([
        x.mean(dim=(1, 2, 3)),
        x.std(dim=(1, 2, 3), correction=0),
        x[:, :, :, 0].mean(dim=(1, 2)),
    ], dim=-1)
    return torch.softmax(feats, dim=-1).cpu().numpy()


def run_host(
    workdir: str,
    options_kwargs: Dict,
    regions: Sequence[str],
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    use_model: bool = False,
    checkpoint: str = "",
    batch_size: int = 64,
    sample_name: str = "default",
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Dict:
    """One process's share of the pipeline; rank 0 merges the global VCF.
    With `num_processes=None` and no torchrun variables this is the
    one-process path. `dtype` is the CNN's compute dtype under
    `use_model`."""
    from deepvariant_tpu_torch.core.genomics_math import round_gls
    from deepvariant_tpu_torch.core.types import CallVariantsOutput
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
    from deepvariant_tpu_torch.make_examples.core import (
        MakeExamplesOptions,
        make_examples_runner,
    )

    device = resolve_device(device)
    pid, n = initialize_multihost(coordinator_address, num_processes,
                                  process_id, device=device,
                                  timeout_s=timeout_s)
    mesh = data_parallel_mesh(device)
    mine = host_shard_assignment(len(regions))

    collected: List[bytes] = []
    options = MakeExamplesOptions(**options_kwargs)
    options.examples_filename = ""
    options.regions = [regions[i] for i in mine]
    if mine:
        make_examples_runner(options, example_sink=collected.append)

    records = [example_codec.parse_example(buf) for buf in collected]
    if records:
        if use_model:
            from deepvariant_tpu_torch.calling.call_variants import Predictor
            from deepvariant_tpu_torch.models.checkpoint import (
                load_variables_for_shape,
            )

            model = load_variables_for_shape(
                checkpoint, records[0].image.shape, device="cpu")
            # A rank computes on its own device only.
            predictor = Predictor(
                model, batch_size=batch_size,
                device=mesh.device if mesh.grouped else device, dtype=dtype)
            pairs = list(predictor.predict_stream(iter(records)))
            probs = np.stack([p for _, p in pairs])
            records = [r for r, _ in pairs]
        else:
            probs = _toy_probabilities(
                np.stack([r.image for r in records]), mesh.device)
    shard_path = os.path.join(
        workdir, f"cvo-{pid:05d}-of-{n:05d}.tfrecord.gz"
    )
    with TFRecordWriter(shard_path) as writer:
        for rec, p in zip(records, probs if records else []):
            cvo = CallVariantsOutput(
                variant=rec.variant,
                alt_allele_indices=rec.alt_allele_indices,
                genotype_probabilities=round_gls(
                    [float(x) for x in p]
                ),
            )
            writer.write(cvo.encode())

    # The all-gather over the group: completion barrier and the global
    # bookkeeping.
    all_counts = gather_counts_across_hosts(len(records), mesh.device)
    result = {
        "process_id": pid,
        "process_count": n,
        "local_examples": len(records),
        "all_counts": [int(x) for x in all_counts],
    }

    if pid == 0:
        from deepvariant_tpu_torch.io.fasta import FastaReader
        from deepvariant_tpu_torch.postprocess.pipeline import (
            postprocess_variants,
        )

        shards = [
            os.path.join(workdir, f"cvo-{i:05d}-of-{n:05d}.tfrecord.gz")
            for i in range(n)
        ]
        # The collective already guarantees every shard is written.
        output_vcf = os.path.join(workdir, "multihost.vcf.gz")
        ref_reader = FastaReader(options_kwargs["ref_filename"])
        pp = postprocess_variants(
            shards, output_vcf, ref_reader.contigs,
            sample_name=sample_name,
        )
        result["output_vcf"] = output_vcf
        result["postprocess"] = pp
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multihost_worker")
    p.add_argument("--workdir", required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--options_json", required=True,
                   help="MakeExamplesOptions kwargs as JSON")
    p.add_argument("--regions_json", required=True)
    p.add_argument("--sample_name", default="default")
    p.add_argument("--use_model", action="store_true",
                   help="classify with InceptionV3 (--checkpoint) instead "
                        "of the toy classifier")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="the CNN's compute dtype under --use_model")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to compute (default: the CUDA card)")
    p.add_argument("--timeout_s", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds before a collective without its peers "
                        "fails")
    args = p.parse_args(argv)
    try:
        result = run_host(
            args.workdir,
            json.loads(args.options_json),
            json.loads(args.regions_json),
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            use_model=args.use_model,
            checkpoint=args.checkpoint,
            batch_size=args.batch_size,
            sample_name=args.sample_name,
            device=args.device,
            dtype=getattr(torch, args.dtype),
            timeout_s=args.timeout_s,
        )
    finally:
        shutdown()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

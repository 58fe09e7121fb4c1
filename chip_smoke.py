#!/usr/bin/env python3
"""Drive the PyTorch port of stage 2 (deepvariant_tpu_torch) on one CUDA
card and check what comes out.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases:
  1. Build every CUDA kernel from csrc/ (one nvcc each, in parallel) and
     print the build time and the compiler's register report.
  2. Hold each kernel against its plain PyTorch version on the card,
     bit-exact: both entry points of the paint kernel (rows form and
     plan form) at the main path's shape and at two shapes whose tiles
     start and end off row and candidate boundaries, on plans with tlen
     -2**31 and support codes outside 0..2. Time both forms and their
     plain versions with CUDA events, and check under torch.profiler
     that one WgsPlanPainter call launches exactly one CUDA kernel.
  3. Staged call_variants: write synthetic 100x221x7 WGS examples and a
     seeded checkpoint with the port's own writers, run the CLI
     (`deepvariant_tpu_torch.scripts.call_variants.main`) on the card at
     batch 512 with the default writer processes, and check the CVOs.
  4. The fused plan path: PlanPredictor over synthetic WGS plans at batch
     512, through the CUDA paint kernel.
  5. One JSON line per the kernels, the card's name and power limit, and
     the result line.

The launch counts are set to 0 just before phases 3 and 4 (the main
path) and read just after; the comparisons of phase 2 and of the checks
after phase 4 are not counted. Any failed check raises, and the script
exits non-zero; it also exits non-zero, printing no result, when no CUDA
card is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_CANDIDATES, ROWS, WIDTH, BAND = 512, 95, 221, 5
# The plan form's arguments, in `paint_pileup_plan`'s order.
PLAN_FORM_KEYS = ("bases", "quals", "mapq", "rev", "tlen", "support",
                  "row_valid", "ref_window")
# (N, R, band, W) of the paint checks: the main path's shape, then two
# whose tiles cut rows and candidates at odd offsets.
PAINT_SHAPES = ((N_CANDIDATES, ROWS, BAND, WIDTH), (3, 93, 7, WIDTH),
                (5, ROWS, BAND, 100))
SHAPE = (100, 221, 7)
N_EXAMPLES = 1024
STAGED_REPEATS = 8  # the example file is read this many times when timed
N_PLANS = 1024
BATCH = 512
SEED = 20261016

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PAINT_OPS_PER_PIXEL = 10         # min, mul, div (quality) + 7 mask muls


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of `reps` single-call times on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 50, repeats: int = 3) -> float:
    """Device time per call of `fn` (CUDA events), the median of
    `repeats` runs of `reps` calls queued behind a spin kernel, so that
    the card runs them back to back whatever the host's launch cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    start_s = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - start_s
    times = []
    for _ in range(repeats):
        # Long enough for the host to queue all `reps` calls (2 GHz bound
        # on the SM clock), at most a second.
        torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def random_plans(n: int, seed: int, rows: int = ROWS, width: int = WIDTH):
    """n WGS plan dicts with invalid rows, N bases, q up to 255, mapq
    above the cap, support codes in and outside 0..2, and tlen negative
    and huge, -2**31 included."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    bases = alphabet[rng.randint(0, 5, (n, rows, width))]
    bases[rng.rand(n, rows, width) < 0.3] = 0
    tlen = rng.randint(-5000, 5000, (n, rows)).astype(np.int32)
    tlen[:, :3] = [-2**31, -2**31 + 1, 2**31 - 1]
    support = rng.randint(0, 3, (n, rows)).astype(np.int8)
    support[:, 3:9] = [-1, -2, -3, -128, 3, 127]
    stacked = {
        "bases": bases,
        "quals": rng.randint(0, 256, (n, rows, width)).astype(np.uint8),
        "mapq": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "rev": rng.rand(n, rows) < 0.5,
        "hp": rng.randint(0, 3, (n, rows)).astype(np.int8),
        "tlen": tlen,
        "supp": rng.rand(n, rows) < 0.1,
        "support": support,
        "af": np.zeros((n, rows), np.uint8),
        "row_valid": rng.rand(n, rows) < 0.85,
        "ref_window": alphabet[rng.randint(0, 5, (n, width))],
    }
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def phase_build() -> float:
    from deepvariant_tpu_torch.ops import _build

    start = time.time()
    messages = _build.build()
    seconds = time.time() - start
    for name, text in messages.items():
        print(f"[build] {name}.cu:\n{text.strip()}")
    print(f"[build] {len(_build.source_names())} kernel source(s) ready in "
          f"{seconds:.2f} s")
    return seconds


def n_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(tensors, out) -> tuple:
    """(bound ms, bound_by): each input read once and the output written
    once at the card's memory rate, against the paint's float32
    operations at its peak."""
    bytes_ms = (n_bytes(tensors) + n_bytes([out])) / H100_BYTES_PER_S * 1e3
    pixels = out.numel() // out.shape[-1]
    ops_ms = pixels * PAINT_OPS_PER_PIXEL / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def kernels_launched(fn) -> list:
    """Names of the device activities (kernels, copies, fills) of one
    call of `fn`, traced by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def phase_paint_kernel(device) -> dict:
    """Both forms of the paint kernel against their plain versions at
    PAINT_SHAPES, their timings at the main path's shape, and the
    painter's one launch."""
    import torch

    from deepvariant_tpu_torch.calling.plan_predictor import PLAN_KEYS
    from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        WgsPlanPainter,
    )
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    max_err, shapes = 0, []
    for k, (n, rows, band, width) in enumerate(PAINT_SHAPES):
        plans = random_plans(n, SEED + k, rows, width)
        t = {key: torch.from_numpy(np.stack([p[key] for p in plans])).to(
            device) for key in PLAN_KEYS}
        painter = WgsPlanPainter(PileupOptions(reference_band_height=band))
        plan_args = [t[key] for key in PLAN_FORM_KEYS]
        rows_args = pp.rows_form_args(*plan_args, painter.colors)
        shapes.append((painter, t, plan_args, rows_args))
        checks = {
            "rows": (pp.paint_pileup(*rows_args),
                     pp.paint_pileup_reference(*rows_args)),
            "plan": (pp.paint_pileup_plan(*plan_args, painter.colors),
                     pp.paint_pileup_plan_reference(*plan_args,
                                                    painter.colors)),
        }
        torch.cuda.synchronize()
        for form, (out, plain) in checks.items():
            err = int((out.int() - plain.int()).abs().max())
            max_err = max(max_err, err)
            if out.shape != plain.shape or not torch.equal(out, plain):
                raise AssertionError(
                    f"paint kernel, {form} form, differs from its plain "
                    f"version at N={n} R={rows} band={band} W={width} "
                    f"(max abs err {err})")
        print(f"[paint] rows and plan forms == plain at N={n} R={rows} "
              f"band={band} W={width}")

    # The main path's shape, the first of PAINT_SHAPES, from here on.
    painter, t, plan_args, rows_args = shapes[0]
    encode_args = [t[key] for key in PLAN_KEYS]
    launched = kernels_launched(lambda: painter(*encode_args))
    print(f"[paint] one WgsPlanPainter call on the card: {launched}")
    if len(launched) != 1 or "paint_kernel" not in launched[0]:
        raise AssertionError(f"the painter launched {len(launched)} device "
                             f"activities, not one paint kernel: {launched}")

    numbers = {}
    for form, kernel, plain, args in (
            ("rows", pp.paint_pileup, pp.paint_pileup_reference, rows_args),
            ("plan", lambda *a: pp.paint_pileup_plan(*a, painter.colors),
             lambda *a: pp.paint_pileup_plan_reference(*a, painter.colors),
             plan_args)):
        out = kernel(*args)
        bound_ms, bound_by = bound(args, out)
        kernel_ms = device_ms(lambda: kernel(*args))
        plain_ms = device_ms(lambda: plain(*args), reps=10)
        numbers[form] = (kernel_ms, plain_ms, bound_ms, bound_by)
        print(f"[paint] {form} form at {tuple(out.shape)}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {n_bytes(args) + n_bytes([out])}"
              f" bytes): {bound_ms / kernel_ms:.1%} of the bound")
    kernel_ms, plain_ms, bound_ms, bound_by = numbers["rows"]
    plan_ms, plan_plain_ms, plan_bound_ms, plan_bound_by = numbers["plan"]
    # A yardstick, not the same function: PyTorch's fill of a tensor the
    # size of the plan form's output, the write traffic alone.
    image = torch.empty((N_CANDIDATES, BAND + ROWS, WIDTH, 7),
                        dtype=torch.uint8, device=device)
    fill_ms = device_ms(lambda: image.fill_(7))
    print(f"[paint] fill_ of the {n_bytes([image])}-byte image: "
          f"{fill_ms:.4f} ms")
    return {
        "name": "pileup_paint",
        "route": "cuda",
        "source": "deepvariant_tpu_torch/csrc/pileup_paint.cu",
        "replaces": "deepvariant_tpu/ops/pileup_paint.py:87",
        "tpu_kernel": "deepvariant_tpu/ops/pileup_paint.py:_paint_kernel",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_diff": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "plan_ms": plan_ms,
        "plan_plain_ms": plan_plain_ms,
        "plan_bound_ms": plan_bound_ms,
        "plan_bound_by": plan_bound_by,
        "image_fill_ms": fill_ms,
    }


def write_staged_inputs(tmp: str):
    """Synthetic examples, their example_info.json, and a seeded
    checkpoint, all written with the port's own writers."""
    import torch

    from deepvariant_tpu_torch.core.types import Variant, VariantCall
    from deepvariant_tpu_torch.io import examples
    from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
    from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
    from deepvariant_tpu_torch.models.checkpoint import save_variables
    from deepvariant_tpu_torch.models.inception_v3 import create_model

    start = time.time()
    rng = np.random.RandomState(SEED)
    path = os.path.join(tmp, "examples.tfrecord")
    with TFRecordWriter(path) as w:
        for i in range(N_EXAMPLES):
            variant = Variant(
                reference_name="chr20", start=10_000 + 3 * i,
                end=10_001 + 3 * i, reference_bases="A",
                alternate_bases=["G"],
                calls=[VariantCall(call_set_name="smoke",
                                   info={"AD": [5, 6], "DP": [11]})])
            image = rng.randint(0, 255, SHAPE, np.uint8)
            w.write(examples.make_example(
                variant, image, [0],
                f"chr20:{10_001 + 3 * i}-{10_002 + 3 * i}"))
    examples.write_example_info(path, SHAPE, WGS_CHANNELS)
    # The timed run reads the file STAGED_REPEATS times as a shard family.
    family = os.path.join(tmp, "repeat")
    for k in range(STAGED_REPEATS):
        os.symlink(path, f"{family}-{k:05d}-of-{STAGED_REPEATS:05d}.tfrecord")
    examples.write_example_info(
        f"{family}-00000-of-{STAGED_REPEATS:05d}.tfrecord", SHAPE,
        WGS_CHANNELS)
    model = create_model(SHAPE[2], dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # He scaling keeps the activations' scale through the ReLUs of the
        # random network, so the probabilities are not all 1/3.
        for module in model.modules():
            if isinstance(module, torch.nn.Conv2d):
                module.weight.mul_(2.0 ** 0.5)
    ckpt_dir = os.path.join(tmp, "ckpt")
    save_variables(os.path.join(ckpt_dir, "model.msgpack"), model,
                   {"shape": list(SHAPE), "channels": WGS_CHANNELS})
    seconds = time.time() - start
    print(f"[staged] wrote {N_EXAMPLES} examples and a checkpoint in "
          f"{seconds:.1f} s")
    return path, f"{family}@{STAGED_REPEATS}.tfrecord", ckpt_dir, model


def run_cli(argv):
    """Run the CLI, which must exit 0; returns (examples, examples/s)."""
    from deepvariant_tpu_torch.scripts import call_variants as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print("[staged] " + text.strip())
    if rc != 0:
        raise AssertionError(f"call_variants CLI exited {rc}")
    m = re.search(r"done: (\d+) examples at ([0-9.]+) examples/s", text)
    return int(m.group(1)), float(m.group(2))


def check_cvos(path: str, expected: int):
    from deepvariant_tpu_torch.calling.call_variants import read_cvos
    from deepvariant_tpu_torch.core.genomics_math import round_gls

    cvos = list(read_cvos(path))
    if len(cvos) != expected:
        raise AssertionError(f"{len(cvos)} CVOs read back, expected "
                             f"{expected}")
    for cvo in cvos:
        p = cvo.genotype_probabilities
        if len(p) != 3 or not all(math.isfinite(x) for x in p) or \
                abs(sum(p) - 1.0) > 1e-9 or round_gls(p) != p:
            raise AssertionError(f"bad probabilities {p} at "
                                 f"{cvo.variant.start}")
    return cvos


def phase_staged(tmp: str, device):
    import torch

    from deepvariant_tpu_torch.calling.call_variants import (
        Predictor,
        iter_examples,
    )

    path, family, ckpt_dir, model = write_staged_inputs(tmp)
    out = os.path.join(tmp, "cvo.tfrecord.gz")
    n, _ = run_cli(["--examples", path, "--outfile", out,
                    "--checkpoint", ckpt_dir, "--batch_size", str(BATCH)])
    check_cvos(out, N_EXAMPLES)
    print(f"[staged] {n} CVOs read back: finite, summing to 1, rounded")
    out2 = os.path.join(tmp, "cvo_repeat.tfrecord.gz")
    n2, rate = run_cli(["--examples", family, "--outfile", out2,
                        "--checkpoint", ckpt_dir, "--batch_size",
                        str(BATCH)])
    check_cvos(out2, N_EXAMPLES * STAGED_REPEATS)

    images = np.stack([r.image for _, r in zip(range(BATCH),
                                               iter_examples([path]))])
    bf16 = Predictor(model, BATCH, device, torch.bfloat16)(images)
    f32 = Predictor(model, BATCH, device, torch.float32)(images)
    agree = float((bf16.argmax(-1) == f32.argmax(-1)).mean())
    max_dp = float(np.abs(bf16 - f32).max())
    print(f"[staged] bf16 vs float32 (TF32 off) on the first batch: argmax "
          f"agreement {agree:.4f}, max |dp| {max_dp:.3g}")
    return {"staged_examples": n2, "staged_examples_per_s": rate,
            "bf16_f32_argmax_agreement": agree,
            "bf16_f32_max_abs_dp": max_dp}, model


def phase_plans(model, device):
    """Returns the timed stream's numbers and the predictor and plans
    for the checks that follow the count read."""
    from deepvariant_tpu_torch.calling.plan_predictor import (
        PlannedExample,
        PlanPredictor,
    )
    from deepvariant_tpu_torch.core.types import Variant
    from deepvariant_tpu_torch.make_examples.pileup import PileupOptions

    plans = random_plans(N_PLANS, SEED + 1)
    payloads = [PlannedExample(p, Variant(start=i), [0], 1)
                for i, p in enumerate(plans)]
    predictor = PlanPredictor(model, PileupOptions(), batch_size=BATCH,
                              device=device)
    for _ in predictor.predict_plan_stream(payloads):  # warm-up pass
        pass
    start = time.time()
    results = list(predictor.predict_plan_stream(payloads))
    seconds = time.time() - start
    probs = np.stack([p for _, p in results])
    if probs.shape != (N_PLANS, 3) or not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-5:
        raise AssertionError("plan path probabilities are malformed")
    print(f"[plans] {N_PLANS} plans in {seconds:.3f} s: "
          f"{N_PLANS / seconds:.1f} plans/s")
    return {"plans": N_PLANS, "plans_per_s": N_PLANS / seconds}, \
        predictor, plans, probs


def check_plan_path(predictor, plans, probs, device):
    """The fused images equal the plain painter's on the same plans, and
    the fused probabilities equal the staged Predictor's on them."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor
    from deepvariant_tpu_torch.calling.plan_predictor import PLAN_KEYS
    from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
    from deepvariant_tpu_torch.make_examples.pileup_device import (
        WgsPlanPainter,
    )

    batch = plans[:BATCH]
    images = predictor.encode(batch).cpu()
    plain = WgsPlanPainter(PileupOptions())(*[
        torch.from_numpy(np.stack([p[k] for p in batch])) for k in PLAN_KEYS])
    if not torch.equal(images, plain):
        raise AssertionError("fused images differ from the plain painter")
    staged = Predictor(predictor.predictor.model, BATCH, device,
                       torch.bfloat16)(images.numpy())
    if not np.array_equal(staged, probs[:BATCH]):
        raise AssertionError(
            "fused probabilities differ from Predictor on the same images "
            f"(max {float(np.abs(staged - probs[:BATCH]).max()):.3g})")
    print("[plans] fused images == plain painter; fused probabilities == "
          "Predictor on those images")


def time_device_steps(predictor, plans, model, device) -> dict:
    """Device time per batch of each step of the fused path (CUDA events,
    inputs already on the card): the painter, and the CNN unfolded and
    with --fast_graph's folded BN and 8-channel stem."""
    import torch

    from deepvariant_tpu_torch.calling.call_variants import Predictor
    from deepvariant_tpu_torch.calling.plan_predictor import PLAN_KEYS

    staged = predictor.stage(plans[:BATCH])
    args = [staged[k] for k in PLAN_KEYS]
    images = predictor.encode_fn(*args)
    fast = Predictor(model, BATCH, device, torch.bfloat16, fold_bn=True,
                     pad_stem_to=8)
    with torch.inference_mode():
        steps = {
            "paint_step_ms": time_ms(lambda: predictor.encode_fn(*args)),
            "paint_step_device_ms": device_ms(
                lambda: predictor.encode_fn(*args)),
            "cnn_ms": time_ms(lambda: predictor.predictor.forward(images),
                              reps=10),
            "cnn_fast_graph_ms": time_ms(lambda: fast.forward(images),
                                         reps=10),
        }
    print("[steps] per batch of %d on the card: " % BATCH + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    return steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepvariant_tpu_torch.device import full_float32_precision
    from deepvariant_tpu_torch.ops import pileup_paint as pp

    device = torch.device("cuda")
    full_float32_precision()
    card = nvidia_smi()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    summary = {"build_s": phase_build()}
    kernels = [phase_paint_kernel(device)]
    wrappers = {"pileup_paint": pp.paint_pileup}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for fn in wrappers.values():
            fn.launches = 0
        staged, model = phase_staged(tmp, device)
        plan_numbers, predictor, plans, probs = phase_plans(model, device)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        check_plan_path(predictor, plans, probs, device)
        summary.update(time_device_steps(predictor, plans, model, device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was not launched on "
                                 "the main path")
    summary.update(staged)
    summary.update(plan_numbers)
    summary["card"] = card
    print(json.dumps({"smoke": summary}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Shared inputs for the tests that hold the PyTorch port
(deepvariant_tpu_torch) against the JAX package."""

import os

import numpy as np

from deepvariant_tpu_torch.models.inception_v3 import (
    InceptionV3,
    to_flax_variables,
)


def random_flax_variables(num_channels, seed=0):
    """An InceptionV3 {params, batch_stats} tree of numpy float32 arrays
    drawn from `seed`: He-scaled kernels, so activations keep their scale
    through the 94 layers and the classes separate, and non-trivial batch
    norm statistics. The same arrays go to both packages."""
    rng = np.random.RandomState(seed)
    layout = to_flax_variables(InceptionV3(num_channels))

    def fill(tree, collection):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value, collection)
                continue
            shape = value.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif key == "var":
                arr = rng.uniform(0.5, 1.5, shape)
            else:  # BN bias and mean, the Dense bias
                arr = rng.standard_normal(shape) * 0.1
            out[key] = arr.astype(np.float32)
        return out

    return {c: fill(t, c) for c, t in layout.items()}


def random_plans(n, seed, rows=95, width=221):
    """Stacked WGS plans with invalid rows, N bases, support codes 0..2,
    mapq above 60 and tlen negative and above 1000."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    bases = alphabet[rng.randint(0, 5, (n, rows, width))]
    bases[rng.rand(n, rows, width) < 0.3] = 0
    return {
        "bases": bases,
        "quals": rng.randint(0, 256, (n, rows, width)).astype(np.uint8),
        "mapq": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "rev": rng.rand(n, rows) < 0.5,
        "hp": rng.randint(0, 3, (n, rows)).astype(np.int8),
        "tlen": rng.randint(-3000, 3000, (n, rows)).astype(np.int32),
        "supp": rng.rand(n, rows) < 0.1,
        "support": rng.randint(0, 3, (n, rows)).astype(np.int8),
        "af": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "row_valid": rng.rand(n, rows) < 0.8,
        "ref_window": alphabet[rng.randint(0, 5, (n, width))],
    }


def edge_plans(plans):
    """Put the painter's edge values into stacked plans, in place: tlen
    at the int32 edges, -2**31 included, and support codes outside
    0..2, on valid rows. JAX wraps a negative code once and clamps: -2
    paints as 1, and -1 as 2."""
    n, rows = plans["tlen"].shape
    tlen = [-2**31, -2**31 + 1, 2**31 - 1, -1000, 1000][:rows]
    support = [-1, -2, -3, -128, 3, 127][:rows]
    plans["tlen"][0, :len(tlen)] = tlen
    plans["support"][n - 1, :len(support)] = support
    plans["row_valid"][0, :len(tlen)] = True
    plans["row_valid"][n - 1, :len(support)] = True
    return plans


def with_alt(plans, seed):
    """Add the alt tensors of diff mode to stacked plans, in place: alt
    bases with '*' and uncovered columns, invalid alt rows, and
    alt_present in all four combinations (from n = 4 on)."""
    rng = np.random.RandomState(seed)
    n, rows, width = plans["bases"].shape
    alphabet = np.frombuffer(b"ACGTN*", np.uint8)
    alt_bases = alphabet[rng.randint(0, 6, (n, 2, rows, width))]
    alt_bases[rng.rand(n, 2, rows, width) < 0.3] = 0
    present = np.array([[1, 1], [0, 1], [1, 0], [0, 0]], bool)
    plans.update({
        "alt_bases": alt_bases,
        "alt_row_valid": rng.rand(n, 2, rows) < 0.8,
        "alt_ref": alphabet[rng.randint(0, 5, (n, 2, width))],
        "alt_present": present[np.arange(n) % 4],
    })
    return plans


def edge_hp(plans):
    """Put hp tags outside 0..2 into stacked plans, in place, on valid
    rows of the second candidate."""
    hp = [-128, -1, 3, 127, 1, 2][:plans["hp"].shape[1]]
    plans["hp"][1, :len(hp)] = hp
    plans["row_valid"][1, :len(hp)] = True
    return plans


def jax_images(plans, options):
    """The JAX package's long-read encoder on stacked plans: (N, band +
    R, W, C) uint8. Plans without the alt tensors get zero ones, which
    the encoder reads only in diff mode."""
    from deepvariant_tpu.make_examples.pileup_jax import (
        make_longread_encode_fn,
    )
    from deepvariant_tpu_torch.calling.plan_predictor import (
        ALT_KEYS,
        PLAN_KEYS,
    )

    n, rows, width = plans["bases"].shape
    zero_alt = dict(zip(ALT_KEYS, (
        np.zeros((n, 2, rows, width), np.uint8),
        np.zeros((n, 2, rows), bool), np.zeros((n, 2, width), np.uint8),
        np.zeros((n, 2), bool))))
    encode = make_longread_encode_fn(options)
    return np.asarray(encode(*[plans[k] for k in PLAN_KEYS],
                             *[plans.get(k, zero_alt[k]) for k in ALT_KEYS]))


# Non-default values of every color option and cap of PileupOptions.
ODD_COLORS = dict(
    base_color_offset_a_and_g=33, base_color_offset_t_and_c=21,
    base_color_stride=55, allele_supporting_read_alpha=0.95,
    allele_unsupporting_read_alpha=0.45,
    other_allele_supporting_read_alpha=0.7,
    reference_matching_read_alpha=0.3,
    reference_mismatching_read_alpha=0.9, reference_base_quality=33,
    positive_strand_color=11, negative_strand_color=222,
    base_quality_cap=37, mapping_quality_cap=51,
    hp_tag_for_assembly_polishing=2)

_CIGARS = ("60M", "20M2I38M", "5S25M3D30M", "30M40N30M", "3H57M2S",
           "10M1I10M1D10M5N29M", "2S1M", "15M4D15M2I15M3H")


def synthetic_region(seed, n_reads=80, span=400):
    """A seeded region of reads and candidates as plain Python values,
    for `build_region` to turn into either package's objects.

    Reads: CIGARs with M, I, D, S, N and H, both strands, paired and
    unpaired, read names shared by mates, HP tags 0..2 and one 3,
    supplementary flags, mapq and base qualities below and above the
    pileup's thresholds. Candidates: four SNP/insertion sites, the first
    and last so close to the reference's ends that their windows hang
    off it. Returns (reference bytes, read field dicts, candidate dicts)."""
    rng = np.random.RandomState(seed)
    reference = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, span)]
    reads = []
    for i in range(n_reads):
        cigar = _CIGARS[i % len(_CIGARS)]
        paired = bool(i % 3)
        reads.append(dict(
            fragment_name=f"read{i // 2:03d}",
            cigar=cigar,
            position=int(rng.randint(0, span - 120)),
            seed=int(rng.randint(1 << 30)),
            mapping_quality=int(rng.randint(0, 71)),
            reverse_strand=bool(rng.randint(2)),
            read_number=i % 2 if paired else 0,
            number_reads=2 if paired else 1,
            fragment_length=int(rng.randint(-1500, 1500)),
            supplementary_alignment=i % 7 == 0,
            proper_placement=paired and i % 5 != 0,
            next_mate_position=("chr1", int(rng.randint(0, span)),
                                bool(rng.randint(2))) if paired else None,
            hp=3 if i == 11 else int(rng.randint(0, 3)),
        ))
    candidates = []
    for start in (5, 130, 200, span - 10):
        picked = rng.permutation(n_reads)
        candidates.append(dict(
            start=start,
            alts=["C", "AT"],
            allele_support={"C": sorted(picked[:15].tolist()),
                            "AT": sorted(picked[15:25].tolist()),
                            "G": sorted(picked[25:28].tolist())},
            allele_frequencies={"C": 0.31, "AT": 0.002},
            combo=["C", "AT"] if len(candidates) % 2 else ["C"],
        ))
    return reference, reads, candidates


def build_region(package, reads, candidates):
    """(ReadBatch, [DeepVariantCall], [alt combo]) of `synthetic_region`'s
    values in one package's classes; `package` is "deepvariant_tpu" or
    "deepvariant_tpu_torch"."""
    import importlib

    def module(name):
        return importlib.import_module(f"{package}.{name}")

    types, cigar, bam = module("core.types"), module("core.cigar"), \
        module("io.bam")
    caller = module("make_examples.variant_caller")
    objects = []
    for r in reads:
        units = cigar.parse_cigar_string(r["cigar"])
        length = cigar.read_span(units)
        rng = np.random.RandomState(r["seed"])
        objects.append(types.Read(
            fragment_name=r["fragment_name"],
            aligned_sequence="".join(
                "ACGT"[b] for b in rng.randint(0, 4, length)),
            aligned_quality=bytes(rng.randint(0, 61, length).tolist()),
            reference_name="chr1", position=r["position"],
            mapping_quality=r["mapping_quality"], cigar=units,
            reverse_strand=r["reverse_strand"],
            read_number=r["read_number"], number_reads=r["number_reads"],
            fragment_length=r["fragment_length"],
            proper_placement=r["proper_placement"],
            supplementary_alignment=r["supplementary_alignment"],
            next_mate_position=r["next_mate_position"],
            info={"HP": [r["hp"]]} if r["hp"] else {}))
    batch = bam.ReadBatch.from_reads(objects, ["chr1", "chr2"])
    calls = [caller.DeepVariantCall(
        variant=types.Variant(
            reference_name="chr1", start=c["start"], end=c["start"] + 1,
            reference_bases="A", alternate_bases=list(c["alts"])),
        allele_support={k: list(v) for k, v in c["allele_support"].items()},
        allele_frequencies=dict(c["allele_frequencies"]))
        for c in candidates]
    return batch, calls, [list(c["combo"]) for c in candidates]


def reference_window(reference, options, variant):
    """The (W,) uint8 pileup reference window of `variant`, N where it
    hangs off the reference."""
    cols = np.arange(options.width) + variant.start - options.half_width
    window = reference[np.clip(cols, 0, len(reference) - 1)].copy()
    window[(cols < 0) | (cols >= len(reference))] = ord("N")
    return window


# -- stage 1: the same objects and files for both packages --------------------

PACKAGES = ("deepvariant_tpu", "deepvariant_tpu_torch")


def package_module(package, name):
    import importlib

    return importlib.import_module(f"{package}.{name}")


def to_package(obj, package):
    """`obj` (a MakeExamplesOptions, ReadBatch, DeepVariantCall,
    PlannedExample, Variant, Range, ... of either package) rebuilt from
    the other package's classes: dataclass fields and ReadBatch columns
    carried across as numpy arrays and plain values, recursively. The
    class is found by name in the module at the same relative path."""
    import dataclasses
    import importlib

    def twin(cls):
        module = cls.__module__
        for prefix in sorted(PACKAGES, key=len, reverse=True):
            if module == prefix or module.startswith(prefix + "."):
                module = package + module[len(prefix):]
                return getattr(importlib.import_module(module), cls.__name__)
        return None

    def convert(value):
        if isinstance(value, np.ndarray):
            return value.copy()
        if isinstance(value, list):
            return [convert(v) for v in value]
        if isinstance(value, tuple):
            return tuple(convert(v) for v in value)
        if isinstance(value, dict):
            return {convert(k): convert(v) for k, v in value.items()}
        cls = type(value)
        target = twin(cls) if hasattr(cls, "__module__") else None
        if target is None:
            return value
        if dataclasses.is_dataclass(value):
            return target(**{f.name: convert(getattr(value, f.name))
                             for f in dataclasses.fields(value)})
        if cls.__name__ == "ReadBatch":
            out = target(list(value.ref_names))
            for slot in cls.__slots__:
                if slot.startswith("_") or slot == "ref_names":
                    continue
                setattr(out, slot, convert(getattr(value, slot)))
            return out
        raise TypeError(f"no conversion for {cls}")

    return convert(obj)


READ_BATCH_COLUMNS = (
    "flag", "ref_id", "pos", "mapq", "seq", "qual", "seq_offsets",
    "cigar_ops", "cigar_lens", "cigar_offsets", "mate_ref_id", "mate_pos",
    "tlen", "hp")


def assert_batches_equal(got, want):
    """Two ReadBatches (of either package) equal field by field, dtypes
    included."""
    assert got.ref_names == want.ref_names
    assert got.name == want.name
    assert got.aux == want.aux
    for column in READ_BATCH_COLUMNS:
        g, w = getattr(got, column), getattr(want, column)
        assert g.dtype == w.dtype, column
        np.testing.assert_array_equal(g, w, err_msg=column)


def assert_calls_equal(got, want):
    """Two lists of DeepVariantCalls: variant bytes, support lists and
    their dict orders."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.variant.encode() == w.variant.encode()
        assert list(g.allele_support.items()) == \
            list(w.allele_support.items())
        assert g.ref_support == w.ref_support
        assert list(g.allele_keys.items()) == list(w.allele_keys.items())
        assert g.allele_frequency_at_position == \
            w.allele_frequency_at_position


def assert_planned_equal(got, want):
    """Two lists of PlannedExamples, in order: variant bytes, alt
    indices, type, and the plans bit-identical key by key."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.variant.encode() == w.variant.encode()
        assert g.alt_indices == w.alt_indices
        assert g.variant_type == w.variant_type and g.label == w.label
        assert list(g.plan) == list(w.plan)
        for key in w.plan:
            assert g.plan[key].dtype == w.plan[key].dtype, key
            assert g.plan[key].shape == w.plan[key].shape, key
            np.testing.assert_array_equal(g.plan[key], w.plan[key],
                                          err_msg=key)


def stage1_sample(seed=7, contig_lengths=(("chr1", 6000), ("chr2", 3000))):
    """The seeded synthetic sample (reference with N runs and a repeat,
    planted SNPs, indels and multi-allelic sites, 30x of 150-base paired
    reads with clips, duplicates, secondary and supplementary flags and
    low mapq)."""
    from deepvariant_tpu_torch.testing import synthetic

    return synthetic.synthetic_sample(seed, contig_lengths)


def write_stage1_inputs(sample, directory, package="deepvariant_tpu"):
    """ref.fa and the indexed reads.bam of `sample`, written by one
    package's writers (the JAX package's unless asked otherwise);
    returns {'ref': path, 'reads': path}."""
    from deepvariant_tpu_torch.testing import synthetic

    return synthetic.write_inputs(
        sample, str(directory), package_module(package, "core.types"),
        package_module(package, "io.bam"),
        package_module(package, "io.bam_writer"))


def wgs_options(package, paths, **overrides):
    """MakeExamplesOptions of one package: WGS preset, realigner off."""
    core = package_module(package, "make_examples.core")
    presets = package_module(package, "make_examples.presets")
    options = core.MakeExamplesOptions(
        reads_filename=paths["reads"], ref_filename=paths["ref"],
        realigner_enabled=False, **overrides)
    return presets.apply_model_preset(options, "WGS")


STAGE1_REGIONS = [
    ("chr1", 0, 1000), ("chr1", 1000, 2000), ("chr1", 4000, 5000),
    ("chr1", 5000, 6000), ("chr2", 0, 1000), ("chr2", 2000, 3000),
    ("chr1", 1180, 1260)]


def region_counters(paths, region, **options):
    """(JAX counter, port counter) over `region`, each fed by its own
    package's readers, built as RegionProcessor._allele_counter does."""
    out = []
    for package in PACKAGES:
        types = package_module(package, "core.types")
        bam = package_module(package, "io.bam")
        fasta = package_module(package, "io.fasta")
        ac = package_module(package, "make_examples.allele_counter")
        name, start, end = region
        ref = fasta.FastaReader(paths["ref"])
        with bam.BamReader(paths["reads"], bam.ReadRequirements(
                min_mapping_quality=5)) as reader:
            batch = reader.query(types.Range(name, start, end))
        tail_end = min(ref.contig_length(name), end + 1000)
        counter = ac.AlleleCounter(
            ref.bases(types.Range(name, start, end)),
            types.Range(name, start, end),
            ac.AlleleCounterOptions(**options),
            ref_prev_base=ref.query(types.Range(name, start - 1, start))
            if start else "N",
            ref_bases_after=ref.bases(types.Range(name, end, tail_end))
            if tail_end > end else None)
        counter.add_batch(batch)
        out.append(counter)
    return out


# -- the realigner and the alt-aligned pileups --------------------------------

# The switches of the JAX package's native library that its realigner
# reads; patched to False they leave its Python and numpy path.
REALIGNER_NATIVES = ("has_ssw", "has_fast_align", "has_fast_pass", "has_dbg",
                     "has_ssw_batch", "has_ssw_multi", "has_merge_cigar")


def realigner_natives_off(monkeypatch, names=REALIGNER_NATIVES):
    """Patch `deepvariant_tpu.io.native.has_*` off for one test."""
    from deepvariant_tpu.io import native

    for name in names:
        monkeypatch.setattr(native, name, lambda: False)


def sparse_sample(seed=7, contig_lengths=(("chr1", 4000), ("chr2", 2000)),
                  **kwargs):
    """The seeded sample with a variant every 400-500 bases: the window
    selector's candidates then stay apart, every window is narrower than
    max_window_size and assembles (at the default spacing of 70 the
    windows merge into ones too wide to assemble)."""
    from deepvariant_tpu_torch.testing import synthetic

    return synthetic.synthetic_sample(seed, contig_lengths,
                                      variant_spacing=400, **kwargs)


def preset_options(package, paths, model_type="WGS", **overrides):
    """MakeExamplesOptions of one package with a model preset applied
    (for WGS the realigner stays on), then `overrides` set on top of it."""
    core = package_module(package, "make_examples.core")
    presets = package_module(package, "make_examples.presets")
    options = presets.apply_model_preset(core.MakeExamplesOptions(
        reads_filename=paths["reads"], ref_filename=paths["ref"]), model_type)
    for key, value in overrides.items():
        assert hasattr(options, key), key
        setattr(options, key, value)
    return options


def region_reads(package, paths, region, min_mapping_quality=5):
    """(ReadBatch, [Read], FastaReader, Range) of one package over
    `region` = (contig, start, end), read from the files."""
    types = package_module(package, "core.types")
    bam = package_module(package, "io.bam")
    fasta = package_module(package, "io.fasta")
    rng = types.Range(*region)
    with bam.BamReader(paths["reads"], bam.ReadRequirements(
            min_mapping_quality=min_mapping_quality)) as reader:
        batch = reader.query(rng)
    return batch, batch.to_reads(), fasta.FastaReader(paths["ref"]), rng


def assert_reads_equal(got, want):
    """Two lists of Reads (of either package) equal field by field."""
    import dataclasses

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def make_reads(package, specs, reference_name="chr1"):
    """Reads of one package from (sequence, position, cigar string,
    mapq, base quality or qualities) tuples."""
    types = package_module(package, "core.types")
    cigar = package_module(package, "core.cigar")
    reads = []
    for i, (seq, position, cigar_string, mapq, qual) in enumerate(specs):
        quals = bytes([qual] * len(seq)) if isinstance(qual, int) \
            else bytes(qual)
        reads.append(types.Read(
            fragment_name=f"r{i}", aligned_sequence=seq,
            aligned_quality=quals, reference_name=reference_name,
            position=position, mapping_quality=mapq,
            cigar=cigar.parse_cigar_string(cigar_string)))
    return reads


# -- stage 3 ------------------------------------------------------------------

def merge_by_contig(monkeypatch, contigs=("chr1", "chr2")):
    """Run the JAX package's gVCF merge one contig at a time. Its merge
    puts a variant first whenever the two streams stand on different
    contigs, so with two contigs it writes the second contig's variants
    before the first contig's last blocks and leaves the second
    contig's blocks unsplit under them
    (`test_jax_merge_interleaves_contigs`); on one contig it is right.
    The port's merge takes the contigs' order, and its gVCF is the
    JAX package's, merged contig by contig, byte for byte."""
    from deepvariant_tpu.postprocess import pipeline as jpipe

    plain = jpipe.merge_variants_and_nonvariants

    def by_contig(variants, nonvariants, ref_lookup=None,
                  only_keep_pass=False):
        variants, nonvariants = list(variants), list(nonvariants)
        for name in contigs:
            yield from plain(
                [v for v in variants if v.reference_name == name],
                [v for v in nonvariants if v.reference_name == name],
                ref_lookup=ref_lookup, only_keep_pass=only_keep_pass)

    monkeypatch.setattr(jpipe, "merge_variants_and_nonvariants", by_contig)


# -- the read-side options ------------------------------------------------------

def tagged_short_sample(seed=7, contig_lengths=(("chr1", 6000),
                                                ("chr2", 3000))):
    """`stage1_sample` with OQ, tp/t0 and right-shifted homopolymer
    indels on its reads (`synthetic.add_read_options`)."""
    from deepvariant_tpu_torch.testing import synthetic

    return synthetic.add_read_options(stage1_sample(seed, contig_lengths),
                                      seed + 100, shifted_indels=40)


def methylated_long_sample(seed=5, contig_lengths=(("chr1", 6000),
                                                   ("chr2", 3000))):
    """A long-read sample at 12x of 2 kb reads with a variant every 600
    bases, the SNPs C>T at CpGs, and MM/ML tags
    (`synthetic.add_methylation`): methylation-aware phasing finds
    informative sites there and phases reads that direct phasing left
    unphased."""
    from deepvariant_tpu_torch.testing import synthetic

    sample = synthetic.synthetic_longread_sample(
        seed, contig_lengths, depth=12, mean_read_length=2000,
        variant_spacing=600, cpg_snps=True)
    return synthetic.add_methylation(sample, seed + 100)


def run_cli_outputs(cli, paths, out_dir, flags, shards=1, mode="calling"):
    """Run one make_examples CLI module over every shard with the
    examples, candidates and gVCF outputs uncompressed; returns
    {output: [shard file bytes]} (a missing output is absent)."""
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs

    os.makedirs(out_dir, exist_ok=True)
    spec = f"@{shards}" if shards > 1 else ""
    files = {name: os.path.join(out_dir, f"{name}.tfrecord{spec}")
             for name in ("examples", "candidates", "gvcf")}
    for task in range(shards):
        argv = ["--mode", mode, "--ref", paths["ref"],
                "--reads", paths["reads"], "--examples", files["examples"],
                "--candidates", files["candidates"], "--gvcf", files["gvcf"],
                "--task", str(task)] + list(flags)
        if shards > 1:
            argv += ["--num_shards", str(shards)]
        assert cli.main(argv) == 0
    out = {}
    for name, spec_path in files.items():
        for path in glob_sharded_inputs(spec_path):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out.setdefault(name, []).append(f.read())
    return out


# -- CRAM and training mode ---------------------------------------------------

def cram_sample(seed=7, contig_lengths=(("chr1", 2500), ("chr2", 1200))):
    """A small sample for the CRAM readers: a twentieth of the reads
    spliced (N ops), OQ, tp/t0 and right-shifted homopolymer indels on
    the reads (`synthetic.add_read_options`)."""
    from deepvariant_tpu_torch.testing import synthetic

    sample = synthetic.synthetic_sample(seed, contig_lengths,
                                        skip_fraction=0.05)
    return synthetic.add_read_options(sample, seed + 100, shifted_indels=10)


def training_inputs(sample, directory, seed=3):
    """ref.fa, reads.bam (the JAX package's writer), reads.cram (rANS
    order 1, the FASTA as reference), truth.vcf.gz and confident.bed of
    `sample`; returns their paths."""
    from deepvariant_tpu_torch.testing import cram_writer, synthetic

    paths = write_stage1_inputs(sample, directory)
    paths.update(synthetic.write_truth_inputs(sample, str(directory), seed))
    paths["cram"] = cram_writer.write_cram(
        sample, os.path.join(str(directory), "reads.cram"))
    return paths

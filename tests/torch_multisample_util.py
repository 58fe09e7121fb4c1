"""Shared inputs of the multi-sample port tests (test_torch_gbz.py,
test_torch_multisample.py, test_torch_product_drivers.py): the seeded
family, tumour/normal pair and pangenome panel of
`deepvariant_tpu_torch/testing/synthetic.py` written to files with the
JAX package's writers, the two packages' multi-sample runners side by
side, and the runner of a JAX test file's cases against the port."""

import importlib
import inspect
import itertools
import os
import types

from deepvariant_tpu_torch.testing import synthetic

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
# run_deeptrio.py's trio heights: child 60, parents 40.
TRIO_HEIGHTS = (40, 60, 40)
WGS_CHANNELS = (1, 2, 3, 4, 5, 6, 19)


def module(package, name):
    return importlib.import_module(f"{package}.{name}")


def _writers(package=JAX):
    return (module(package, "core.types"), module(package, "io.bam"),
            module(package, "io.bam_writer"))


def write_family(directory, seed=7, contig_lengths=(("chr1", 3000),)):
    """ref.fa and parent1/child/parent2 BAMs of `synthetic_family`."""
    family = synthetic.synthetic_family(seed, contig_lengths)
    os.makedirs(str(directory), exist_ok=True)
    paths = {"ref": synthetic.write_fasta(
        family["child"], os.path.join(str(directory), "ref.fa"))}
    for role in ("parent1", "child", "parent2"):
        paths[role] = synthetic.write_bam(
            family[role], os.path.join(str(directory), f"{role}.bam"),
            *_writers())
    return paths, family


def write_tumor_normal(directory, seed=11, contig_lengths=(("chr1", 3000),)):
    """ref.fa and normal/tumor BAMs of `synthetic_tumor_normal`."""
    pair = synthetic.synthetic_tumor_normal(seed, contig_lengths)
    os.makedirs(str(directory), exist_ok=True)
    paths = {"ref": synthetic.write_fasta(
        pair["normal"], os.path.join(str(directory), "ref.fa"))}
    for role in ("normal", "tumor"):
        paths[role] = synthetic.write_bam(
            pair[role], os.path.join(str(directory), f"{role}.bam"),
            *_writers())
    return paths, pair


def write_pangenome(directory, seed=13, contig_lengths=(("chr1", 3000),)):
    """ref.fa, reads.bam, the panel as a BAM of haplotype alignments
    (panel.bam), the same BAM with the contigs named without "chr"
    (panel_nochr.bam) and the panel as a GBZ (panel.gbz, the JAX
    writer)."""
    data = synthetic.synthetic_pangenome(seed, contig_lengths)
    d = str(directory)
    os.makedirs(d, exist_ok=True)
    panel_reads = synthetic.panel_sample(data["panel"])
    paths = {
        "ref": synthetic.write_fasta(data["reads"],
                                     os.path.join(d, "ref.fa")),
        "reads": synthetic.write_bam(data["reads"],
                                     os.path.join(d, "reads.bam"),
                                     *_writers()),
        "panel_bam": synthetic.write_bam(panel_reads,
                                         os.path.join(d, "panel.bam"),
                                         *_writers()),
        "panel_nochr": synthetic.write_bam(
            panel_reads, os.path.join(d, "panel_nochr.bam"), *_writers(),
            contig_prefix="chr"),
        "panel_gbz": synthetic.write_panel_gbz(
            data["panel"], os.path.join(d, "panel.gbz"),
            module(JAX, "io.gbz")),
    }
    return paths, data


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def run_multisample(package, out_dir, options, samples, main_index):
    """One package's `make_multisample_examples_runner` with `options`
    (keyword arguments of MakeExamplesOptions, plus `variant_caller` and
    `pileup` dicts set on those sub-options) and `samples` (keyword
    dicts of SampleSpec), every output uncompressed under `out_dir`;
    returns ({output: bytes}, counts)."""
    core = module(package, "make_examples.core")
    ms = module(package, "make_examples.multisample")
    os.makedirs(str(out_dir), exist_ok=True)
    files = {name: os.path.join(str(out_dir), f"{name}.tfrecord")
             for name in ("examples", "candidates", "gvcf")}
    kwargs = dict(options)
    caller = kwargs.pop("variant_caller", {})
    pileup = kwargs.pop("pileup", {})
    o = core.MakeExamplesOptions(
        examples_filename=files["examples"],
        candidates_filename=files["candidates"],
        gvcf_filename=files["gvcf"], **kwargs)
    for key, value in caller.items():
        setattr(o.variant_caller_options, key, value)
    for key, value in pileup.items():
        setattr(o.pileup_options, key, value)
    specs = [ms.SampleSpec(**s) for s in samples]
    counts = ms.make_multisample_examples_runner(o, specs, main_index)
    out = {name: read_bytes(path) for name, path in files.items()}
    out["example_info"] = read_bytes(
        files["examples"] + ".example_info.json")
    return out, counts


def trio_specs(paths, heights=TRIO_HEIGHTS, order=("parent1", "child",
                                                    "parent2")):
    return [dict(role=role, reads_filename=paths[role], sample_name=role,
                 pileup_height=h) for role, h in zip(order, heights)]


# -- a JAX test file's cases, run against the port ----------------------------

def port_twin(test_module):
    """`test_module`'s source executed once more with its imports of the
    JAX package pointing at the port."""
    path = test_module.__file__
    with open(path) as f:
        source = f.read().replace("deepvariant_tpu.", "deepvariant_tpu_torch.")
    twin = types.ModuleType(test_module.__name__ + "_on_the_port")
    twin.__file__ = path
    exec(compile(source, path, "exec"), twin.__dict__)
    return twin


def _grid(fn, taken=("self",)):
    """The parameter sets of `fn`'s parametrize marks, or [{}] for a
    test without them; None when it needs a fixture."""
    marks = getattr(fn, "pytestmark", [])
    if any(m.name == "integration" for m in marks):
        return None
    args = [a for a in inspect.signature(fn).parameters if a not in taken]
    axes = []
    for m in (m for m in marks if m.name == "parametrize"):
        names = [n.strip() for n in m.args[0].split(",")] \
            if isinstance(m.args[0], str) else list(m.args[0])
        axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                     for v in m.args[1]])
    out = []
    for combo in itertools.product(*axes):
        params = {}
        for part in combo:
            params.update(part)
        if set(params) == set(args):
            out.append(params)
    return out or None


def twin_cases(test_module, fixtures=()):
    """(id, class name or None, function name, params) of every test of
    `test_module` that needs no fixture but those named in `fixtures`,
    each parametrized case on its own."""
    taken = ("self",) + tuple(fixtures)
    out = []
    for name, obj in sorted(vars(test_module).items()):
        if name.startswith("test_") and inspect.isfunction(obj):
            for k, params in enumerate(_grid(obj, taken) or []):
                out.append((f"{name}[{k}]", None, name, params))
        elif name.startswith("Test") and inspect.isclass(obj):
            for fname, fn in sorted(vars(obj).items()):
                if fname.startswith("test_"):
                    for k, params in enumerate(_grid(fn, taken) or []):
                        out.append((f"{name}.{fname}[{k}]", name, fname,
                                    params))
    return out


def run_twin_case(twin, cls_name, name, params, **fixtures):
    """One case of `twin_cases`, given the fixtures its function names."""
    owner = twin if cls_name is None else getattr(twin, cls_name)()
    if cls_name is not None and hasattr(owner, "setup_method"):
        owner.setup_method()
    fn = getattr(owner, name)
    wanted = inspect.signature(fn).parameters
    fn(**params, **{k: v for k, v in fixtures.items() if k in wanted})

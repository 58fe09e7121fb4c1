"""io/genomics_io.py of the PyTorch port against the JAX package's.

Plain text in both packages: seeded BED (3, 6 and 12 fields), bedGraph,
FASTQ and GFF records written by each package's writer, plain and
gzipped, must give the same text (gzip's header carries a time, so
gzipped files are compared decompressed), and each package's reader
must read either file back to the records written. The JAX
`tests/test_io_formats.py` cases run once more on the port's modules.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

import test_io_formats
from deepvariant_tpu.io import genomics_io as jio
from deepvariant_tpu_torch.io import genomics_io as tio
from torch_multisample_util import port_twin, run_twin_case, twin_cases

torch.set_num_threads(2)

TWIN = port_twin(test_io_formats)
CASES = twin_cases(TWIN, ("tmp_path",))


def test_jax_cases_are_collected():
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_jax_case_on_the_port(case, tmp_path):
    _id, cls_name, name, params = case
    run_twin_case(TWIN, cls_name, name, params, tmp_path=tmp_path)


def _bases(rng, n):
    return "".join(rng.choice(list("ACGTN"), n))


def records(kind: str, seed: int) -> list:
    """Seeded records of one format as plain dicts of their fields."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(int(rng.randint(5, 20))):
        start = int(rng.randint(0, 100_000))
        end = start + int(rng.randint(1, 5000))
        name = f"chr{rng.randint(1, 23)}"
        if kind == "bed":
            sizes = rng.randint(1, 50, 3)
            out.append(dict(
                reference_name=name, start=start, end=end,
                name=f"feature{i}", score=float(rng.randint(0, 1000)) / 8,
                strand=str(rng.choice(["+", "-", "."])),
                thick_start=start, thick_end=end,
                item_rgb=",".join(map(str, rng.randint(0, 256, 3))),
                block_count=3, block_sizes=",".join(map(str, sizes)),
                block_starts="0,60,120"))
        elif kind == "bedgraph":
            out.append(dict(reference_name=name, start=start, end=end,
                            data_value=float(rng.randint(-400, 400)) / 16))
        elif kind == "fastq":
            n = int(rng.randint(1, 200))
            out.append(dict(
                id=f"read{seed}_{i}",
                description="" if i % 3 == 0 else f"pass {i} len={n}",
                sequence=_bases(rng, n),
                quality="".join(chr(33 + q) for q in rng.randint(0, 42, n))))
        else:
            attributes = {} if i % 4 == 0 else {
                "ID": f"gene{i}", "Name": f"G{rng.randint(1000)}"}
            out.append(dict(
                reference_name=name, source=str(rng.choice(["src", "hav"])),
                type=str(rng.choice(["gene", "exon", "CDS"])), start=start,
                end=end,
                score=None if i % 3 == 0 else float(rng.randint(0, 99)) / 4,
                strand=str(rng.choice(["+", "-"])),
                phase=None if i % 2 else int(rng.randint(0, 3)),
                attributes=attributes))
    return out


FORMATS = {"bed": ("BedRecord", "BedReader", "BedWriter"),
           "bedgraph": ("BedGraphRecord", "BedGraphReader", "BedGraphWriter"),
           "fastq": ("FastqRecord", "FastqReader", "FastqWriter"),
           "gff": ("GffRecord", "GffReader", "GffWriter")}
# (format, writer arguments)
WRITERS = [("bed", {"num_fields": 3}), ("bed", {"num_fields": 6}),
           ("bed", {"num_fields": 12}), ("bedgraph", {}), ("fastq", {}),
           ("gff", {}), ("gff", {"header_lines": ["##sequence-region c 1 9"]})]


def _text(path: str) -> str:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return f.read()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("writer", range(len(WRITERS)),
                         ids=[f"{k}-{'-'.join(map(str, a.values()))}"
                              for k, a in WRITERS])
def test_round_trip_equals_jax(writer, suffix, seed, tmp_path):
    kind, args = WRITERS[writer]
    record_cls, reader_cls, writer_cls = FORMATS[kind]
    want = records(kind, seed)
    paths = {}
    for name, mod in (("jax", jio), ("port", tio)):
        paths[name] = str(tmp_path / f"{name}.{kind}{suffix}")
        with getattr(mod, writer_cls)(paths[name], **args) as w:
            for fields in want:
                w.write(getattr(mod, record_cls)(**fields))
    assert _text(paths["port"]) == _text(paths["jax"])
    if suffix:
        with open(paths["port"], "rb") as f:
            assert f.read(2) == b"\x1f\x8b"
    for mod in (jio, tio):
        for path in paths.values():
            got = [dataclasses.asdict(r)
                   for r in getattr(mod, reader_cls)(path)]
            assert len(got) == len(want)
            if kind == "bed":
                n = args["num_fields"]
                defaults = dataclasses.asdict(tio.BedRecord("", 0, 0))
                keys = list(defaults)
                expect = [{k: (w[k] if i < n else defaults[k])
                           for i, k in enumerate(keys)} for w in want]
                assert got == expect
            else:
                assert got == want

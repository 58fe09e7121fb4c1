"""The one traffic generator: seeded plans that look like pileups.

A plan is what a make_examples worker ships to the card for one
candidate: the read rows of its pileup window, gathered (bases and
qualities per column, one value per row for the rest), and the reference
window. Here each plan is drawn from parameters:

- the configuration's `reads`: read length, substitution error rate,
  base-quality range, share of low mapping qualities, insert size (or
  none, unpaired), whether reads carry haplotype tags, the share of
  supplementary alignments;
- the traffic file: the range of read rows per plan, the share of plans
  with an alt allele at the centre column, and among those the shares
  that are hom-alt and that are indels (which, in diff mode, carry the
  alt-aligned rows).

Every seed gets the same multiset of read depths and the same numbers
of ref, het, hom-alt and indel plans, in another order: the seed changes
the data, not the work. Everything is drawn on `device` with one
generator.
"""

from __future__ import annotations

from typing import Dict

import torch

ACGT = (65, 67, 71, 84)
PLAN_KEYS = ("bases", "quals", "mapq", "rev", "hp", "tlen", "supp",
             "support", "af", "row_valid", "ref_window")
ALT_KEYS = ("alt_bases", "alt_row_valid", "alt_ref", "alt_present")
SNP, INDEL = 1, 2


def diff_mode(pileup: Dict) -> bool:
    return pileup["alt_aligned_pileup"] == "diff_channels"


def planes(pileup: Dict) -> int:
    """The image's planes: the channels, and the two diff planes."""
    return len(pileup["channels"]) + (2 if diff_mode(pileup) else 0)


def keys(pileup: Dict):
    """The plan tensors a painter of these options reads."""
    return PLAN_KEYS + (ALT_KEYS if diff_mode(pileup) else ())


def _shares(n: int, share: float, g, device) -> torch.Tensor:
    """A bool (n,) with round(n * share) True, in a seeded order."""
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=g, device=device)[:round(n * share)]] \
        = True
    return mask


def make_plans(n: int, config: Dict, traffic: Dict, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """n stacked plans on `device` (PLAN_KEYS, plus ALT_KEYS when the
    configuration paints the diff planes), with `labels` (0 ref, 1 het,
    2 hom-alt) and `variant_types` (1 SNP, 2 indel)."""
    p = config["pileup"]
    reads = config["reads"]
    height, width = p["height"], p["width"]
    rows = height - p["reference_band_height"]
    centre = (width - 1) // 2
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    acgt = torch.tensor(ACGT, dtype=torch.uint8, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randint(lo, hi, *shape):  # lo..hi inclusive
        return torch.randint(lo, hi + 1, shape, generator=g, device=device)

    # The work: read depths and genotype counts, the same for every seed.
    lo, hi = traffic["min_reads"], min(traffic["max_reads"], rows)
    depth = lo + torch.arange(n, device=device) * (hi - lo + 1) // n
    depth = depth[torch.randperm(n, generator=g, device=device)]
    has_alt = _shares(n, traffic["alt_share"], g, device)
    order = torch.randperm(n, generator=g, device=device)
    alt_rank = torch.cumsum(has_alt[order], 0) - 1
    n_alt = int(has_alt.sum())
    hom = torch.zeros(n, dtype=torch.bool, device=device)
    indel = torch.zeros(n, dtype=torch.bool, device=device)
    hom[order] = has_alt[order] & (
        alt_rank < round(n_alt * traffic["hom_alt_share"]))
    indel_rank = (alt_rank * 7919) % max(n_alt, 1)  # another order
    indel[order] = has_alt[order] & (
        indel_rank < round(n_alt * traffic["indel_share"]))
    labels = has_alt.to(torch.int32) + hom.to(torch.int32)
    vaf = torch.where(hom, 1.0, torch.where(has_alt, 0.5, 0.0))

    ref = acgt[randint(0, 3, n, width)]
    ref_code = randint(0, 3, n)
    ref[:, centre] = acgt[ref_code]
    alt_base = acgt[(ref_code + randint(1, 3, n)) % 4]

    valid = torch.arange(rows, device=device)[None, :] < depth[:, None]
    length = reads["read_length"]
    start = centre - randint(0, length - 1, n, rows)
    cols = torch.arange(width, device=device)
    covered = ((cols >= start[:, :, None]) & (cols < start[:, :, None]
                                              + length)
               & valid[:, :, None])
    supports = (rand(n, rows) < vaf[:, None]) & valid
    bases = ref[:, None, :].expand(n, rows, width).clone()
    bases[:, :, centre] = torch.where(supports, alt_base[:, None],
                                      ref[:, centre][:, None])
    errors = rand(n, rows, width) < reads["base_error_rate"]
    bases = torch.where(errors, acgt[randint(0, 3, n, rows, width)], bases)
    bases = torch.where(covered, bases, torch.zeros_like(bases))
    q_lo, q_hi = reads["base_quality"]
    quals = torch.where(covered, randint(q_lo, q_hi, n, rows, width),
                        0).to(torch.uint8)
    mapq = torch.where(rand(n, rows) < reads["low_mapq_share"],
                       randint(0, 59, n, rows), 60)
    rev = (rand(n, rows) < 0.5) & valid
    if reads["phased"]:
        hp = torch.where(has_alt[:, None] & ~hom[:, None],
                         torch.where(supports, 1, 2), randint(0, 2, n, rows))
    else:
        hp = torch.zeros((n, rows), dtype=torch.int64, device=device)
    if reads["insert_size"]:
        mean, sd = reads["insert_size"]
        size = (mean + sd * torch.randn((n, rows), generator=g,
                                        device=device)).round().clamp_min(1)
        tlen = torch.where(rev, -size, size).to(torch.int32)
    else:
        tlen = torch.zeros((n, rows), dtype=torch.int32, device=device)
    plans = {
        "bases": bases,
        "quals": quals,
        "mapq": (mapq * valid).to(torch.uint8),
        "rev": rev,
        "hp": (hp * valid).to(torch.int8),
        "tlen": tlen * valid,
        "supp": (rand(n, rows) < reads["supplementary_share"]) & valid,
        "support": supports.to(torch.int8),
        "af": torch.zeros((n, rows), dtype=torch.uint8, device=device),
        "row_valid": valid,
        "ref_window": ref,
        "labels": labels,
        "variant_types": torch.where(indel, INDEL, SNP).to(torch.int32),
    }
    if diff_mode(p):
        # Indel candidates carry their reads realigned to the alt
        # haplotype (both slots: a single alt falls back to itself).
        present = indel[:, None].expand(n, 2).contiguous()
        alt_ref = ref.clone()
        alt_ref[:, centre] = alt_base
        plans["alt_bases"] = torch.where(
            present[:, :, None, None], bases[:, None], 0).to(torch.uint8)
        plans["alt_row_valid"] = present[:, :, None] & valid[:, None, :]
        plans["alt_ref"] = torch.where(present[:, :, None],
                                       alt_ref[:, None, :], 0).to(torch.uint8)
        plans["alt_present"] = present
    return plans

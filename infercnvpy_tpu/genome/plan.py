"""Host-side window planning for the device smoothing kernel.

The reference computes the running mean chromosome-by-chromosome with ragged
Python control flow (reference: tl/_infercnv.py:301-356).  This design
instead precomputes, once per (var, window_size, step) combination, a
static *packed layout*:

* all genes of "regular" chromosomes (more genes than the window) are laid out
  on one packed axis, each chromosome starting at a step-aligned offset;
* ONE strided convolution over the packed axis then computes every
  chromosome's running windows simultaneously (invalid cross-boundary windows
  are never gathered);
* "small" chromosomes (#genes <= window, reference: tl/_infercnv.py:227-244)
  reduce to a per-chromosome uniform mean, computed by a tiny segment mean;
* a final static gather interleaves both groups back into natural chromosome
  order, which also defines ``chr_pos``.

Everything here is plain numpy; the resulting integer arrays are constants
baked into the jitted compute (no dynamic shapes, no ragged loops on device).
"""

from __future__ import annotations

import re
from collections.abc import Sequence
from dataclasses import dataclass, field

import numpy as np
import pandas as pd

__all__ = ["natural_sort", "WindowPlan", "build_window_plan", "GeneProjectionData", "gene_projection_data"]


def natural_sort(items: Sequence[str]) -> list[str]:
    """Natural (human) sort: chr2 < chr11 (behavior matches reference tl/_infercnv.py:164-176)."""

    def alphanum_key(key: str):
        return [int(c) if c.isdigit() else c.lower() for c in re.split(r"([0-9]+)", key)]

    return sorted(items, key=alphanum_key)


@dataclass
class WindowPlan:
    """Static execution plan for the genomic running-window smoothing.

    All index arrays refer to the *masked* gene axis (genes that survived the
    null-chromosome / excluded-chromosome mask in ``tl.infercnv``).
    """

    window_size: int
    step: int

    #: chromosome names in natural order (only ``chr*`` and not ``chrM``;
    #: behavior matches reference tl/_infercnv.py:327)
    chromosomes: list[str] = field(default_factory=list)
    #: chromosome -> first column of its windows in the final window axis
    chr_pos: dict = field(default_factory=dict)
    #: total number of output windows
    n_windows: int = 0

    # --- packed-conv path (regular chromosomes: n_genes > window_size) ---
    #: length of the packed gene axis (step-aligned chromosome offsets)
    packed_len: int = 0
    #: int32[packed_len]; packed position -> masked-gene index, -1 = zero pad
    packed_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    #: int32[n_reg_windows]; valid strided-conv output positions, ordered by
    #: chromosome then window
    conv_gather: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    # --- uniform path (small chromosomes: n_genes <= window_size) ---
    #: int32[n_small_genes]; masked-gene indices, chromosome-major sorted by start
    small_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    #: int32[n_small_genes]; which small chromosome each gene belongs to
    small_seg: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    #: int32[n_small]; gene count per small chromosome
    small_counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    # --- assembly ---
    #: int32[n_windows]; final[k] = concat(reg_windows, small_windows)[final_src[k]]
    final_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    # --- per-gene back-projection (calculate_gene_values) ---
    #: int32[n_used_genes]; masked-gene index of every gene that belongs to a
    #: planned chromosome, chromosome-major sorted by start
    used_genes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    #: int32[n_used_genes]; first / last covering window (final coords), -1 = uncovered
    gene_win_lo: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    gene_win_hi: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n_reg_windows(self) -> int:
        return int(len(self.conv_gather))

    @property
    def cache_key(self) -> str:
        """Stable content digest — lets jitted-transform builders memoize per plan.

        Two plans built from identical (var, window_size, step) inputs hash
        equal, so repeated ``tl.infercnv`` calls over the same genome reuse
        one traced/compiled executable instead of recompiling.
        """
        key = getattr(self, "_cache_key", None)
        if key is None:
            import hashlib

            h = hashlib.sha256()
            h.update(repr((self.window_size, self.step, self.n_windows, self.packed_len,
                           tuple(self.chromosomes), tuple(self.chr_pos.items()))).encode())
            for arr in (self.packed_src, self.conv_gather, self.small_src, self.small_seg,
                        self.small_counts, self.final_src, self.used_genes,
                        self.gene_win_lo, self.gene_win_hi):
                h.update(np.ascontiguousarray(arr).tobytes())
            key = self._cache_key = h.hexdigest()
        return key

    @property
    def n_small(self) -> int:
        return int(len(self.small_counts))

    @property
    def pyramid(self) -> np.ndarray:
        """Normalized pyramidal window weights (reference: tl/_infercnv.py:206-212)."""
        n = self.window_size
        r = np.arange(1, n + 1)
        pyr = np.minimum(r, r[::-1]).astype(np.float64)
        return pyr / pyr.sum()

    @property
    def pyramid_sum(self) -> float:
        """Sum of the unnormalized pyramid weights (normalization constant)."""
        n = self.window_size
        r = np.arange(1, n + 1)
        return float(np.minimum(r, r[::-1]).sum())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_window_plan(
    var: pd.DataFrame,
    window_size: int,
    step: int,
    pad_to: int = 128,
) -> WindowPlan:
    """Build the static window plan from a (masked) var DataFrame.

    ``var`` must have ``chromosome`` and ``start`` columns; its row order
    defines the masked gene axis.  Gene ordering within a chromosome follows
    the reference (sort by ``start``; reference: tl/_infercnv.py:350).
    """
    n = int(window_size)
    s = int(step)
    if n < 1 or s < 1:
        raise ValueError("window_size and step must be >= 1")

    chrom_values = var["chromosome"].astype(str).values
    chromosomes = natural_sort([c for c in pd.unique(chrom_values) if c.startswith("chr") and c != "chrM"])

    plan = WindowPlan(window_size=n, step=s, chromosomes=chromosomes)

    starts = var["start"].values
    positions = np.arange(len(var))

    # per-chromosome sorted masked-gene indices (ties resolved like pandas
    # sort_values default, i.e. numpy stable=False quicksort on the start values)
    per_chrom_idx: dict[str, np.ndarray] = {}
    for c in chromosomes:
        mask = chrom_values == c
        idx = positions[mask]
        order = pd.Series(starts[mask]).sort_values(kind="quicksort").index.to_numpy()
        per_chrom_idx[c] = idx[order]

    reg = [c for c in chromosomes if len(per_chrom_idx[c]) > n]
    small = [c for c in chromosomes if 0 < len(per_chrom_idx[c]) <= n]
    small_rank = {c: i for i, c in enumerate(small)}

    # ---- packed layout for regular chromosomes
    offsets: dict[str, int] = {}
    cursor = 0
    for c in reg:
        offsets[c] = cursor
        cursor = _round_up(cursor + len(per_chrom_idx[c]), s)
    # ensure the strided conv emits every needed output position
    needed = 0
    reg_windows: dict[str, int] = {}
    for c in reg:
        g = len(per_chrom_idx[c])
        w_c = (g - n) // s + 1  # reference: len(range(0, g-n+1, s))
        reg_windows[c] = w_c
        needed = max(needed, offsets[c] + s * (w_c - 1) + n)
    # multiple of step (for the phase-major view) and lane-padded
    packed_len = _round_up(_round_up(max(needed, n), s), pad_to * s) if reg else 0

    packed_src = np.full(packed_len, -1, dtype=np.int32)
    for c in reg:
        idx = per_chrom_idx[c]
        packed_src[offsets[c] : offsets[c] + len(idx)] = idx

    conv_gather_parts = []
    reg_window_start: dict[str, int] = {}
    acc = 0
    for c in reg:
        reg_window_start[c] = acc
        w_c = reg_windows[c]
        conv_gather_parts.append(offsets[c] // s + np.arange(w_c, dtype=np.int32))
        acc += w_c
    conv_gather = np.concatenate(conv_gather_parts).astype(np.int32) if conv_gather_parts else np.zeros(0, np.int32)

    # ---- small chromosomes
    small_src_parts, small_seg_parts, small_counts = [], [], []
    for c in small:
        idx = per_chrom_idx[c]
        small_src_parts.append(idx.astype(np.int32))
        small_seg_parts.append(np.full(len(idx), small_rank[c], dtype=np.int32))
        small_counts.append(len(idx))
    plan.small_src = np.concatenate(small_src_parts).astype(np.int32) if small_src_parts else np.zeros(0, np.int32)
    plan.small_seg = np.concatenate(small_seg_parts).astype(np.int32) if small_seg_parts else np.zeros(0, np.int32)
    plan.small_counts = np.asarray(small_counts, dtype=np.int32)

    # ---- final assembly order + chr_pos
    final_src_parts = []
    chr_pos: dict[str, int] = {}
    cum = 0
    n_reg_total = int(acc)
    for c in chromosomes:
        g = len(per_chrom_idx[c])
        if g == 0:
            continue
        chr_pos[c] = cum
        if c in reg_windows:
            w_c = reg_windows[c]
            final_src_parts.append(reg_window_start[c] + np.arange(w_c, dtype=np.int32))
            cum += w_c
        else:
            final_src_parts.append(np.asarray([n_reg_total + small_rank[c]], dtype=np.int32))
            cum += 1
    plan.final_src = np.concatenate(final_src_parts).astype(np.int32) if final_src_parts else np.zeros(0, np.int32)
    plan.chr_pos = chr_pos
    plan.n_windows = cum
    plan.packed_len = packed_len
    plan.packed_src = packed_src
    plan.conv_gather = conv_gather

    # ---- per-gene coverage (for calculate_gene_values back-projection)
    used, lo, hi = [], [], []
    for c in chromosomes:
        idx = per_chrom_idx[c]
        g = len(idx)
        if g == 0:
            continue
        base = chr_pos[c]
        if c in reg_windows:
            w_c = reg_windows[c]
            ranks = np.arange(g)
            j_lo = np.maximum(0, -(-(ranks - n + 1) // s))  # ceil((r-n+1)/s)
            j_hi = np.minimum(w_c - 1, ranks // s)
            covered = j_lo <= j_hi
            lo.append(np.where(covered, base + j_lo, -1).astype(np.int32))
            hi.append(np.where(covered, base + j_hi, -1).astype(np.int32))
        else:
            lo.append(np.full(g, base, dtype=np.int32))
            hi.append(np.full(g, base, dtype=np.int32))
        used.append(idx.astype(np.int32))
    plan.used_genes = np.concatenate(used).astype(np.int32) if used else np.zeros(0, np.int32)
    plan.gene_win_lo = np.concatenate(lo).astype(np.int32) if lo else np.zeros(0, np.int32)
    plan.gene_win_hi = np.concatenate(hi).astype(np.int32) if hi else np.zeros(0, np.int32)

    return plan


@dataclass(frozen=True)
class GeneProjectionData:
    """Which used genes get a per-gene value (``calculate_gene_values``)."""

    covered_sorted: np.ndarray  #: (n_covered,) used-gene index of each gene-value column (ascending)
    total: int  #: number of covered genes


#: id(plan) -> (plan, gpd).  The plan object itself is stored in the value so
#: it stays alive for the lifetime of the cache entry — otherwise a
#: garbage-collected plan could hand its id to a NEW plan, which would then
#: silently receive the old plan's projection data.
_gpd_cache: dict = {}


def gene_projection_data(plan: WindowPlan) -> GeneProjectionData:
    """Covered-gene columns of a plan (genes inside at least one window), memoized per plan."""
    hit = _gpd_cache.get(id(plan))
    if hit is not None and hit[0] is plan:
        return hit[1]
    covered = np.flatnonzero(plan.gene_win_lo >= 0).astype(np.int64)
    gpd = GeneProjectionData(covered_sorted=covered, total=int(len(covered)))
    _gpd_cache[id(plan)] = (plan, gpd)
    return gpd

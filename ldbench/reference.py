"""The plain reference: what the tools must write, from the generated data.

It works from a :class:`ldbench.data.Dataset` (the arrays the benchmark
made, never the port's store) in plain PyTorch and NumPy, and imports
nothing of the port and nothing of JAX.  The LD of a pair follows the
reference tool's ``calc_ld`` (SURVEY.md §0; tests/oracle.py is the same
arithmetic in pure Python): each variant's genotype list holds the cohort's
alleles in sample order (two for a diploid cell, one for a haploid one), a
pair walks the two lists zipped to the shorter, each side counts its alt
alleles over its own whole list, and every frequency divides by the walk
length::

    p_ab = c_ab / n,  p = c / n,  q = (len - c) / n,  d = p_ab - p1 * p2
    d >= 0: den = min(p1 * q2, q1 * p2);  d < 0: den = max(-p1 * p2, -q1 * q2)
    den == 0: D' = int 0, else D' = d / den
    D' == 0:  r2 = int 0, else r2 = d ** 2 / (p1 * q1 * p2 * q2)

and every value is written as ``str(round(v, 4))``.  Counts are exact
integers (popcounts of packed rows, or float32 products of 0/1 rows with
TF32 off, exact below 2^24); the finish runs one operation at a time in
``dtype``: float64 as the reference, float32 for the lower-precision
control.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BLOCK_ROWS = 65_536    # rows a band pass takes at a time
RECT_ROWS = 4096       # rows of a cross-profile block
RECT_COLS = 16_384     # its columns


# ---- genotype lists ------------------------------------------------------

def popcount_rows(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of a uint8 (n, w) tensor, as int64."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=1, dtype=torch.int64)


def unpack_rows(x: torch.Tensor, n_hap: int) -> torch.Tensor:
    """uint8 (n, w) packed rows -> float32 (n, n_hap) of 0/1."""
    shifts = torch.arange(7, -1, -1, device=x.device, dtype=torch.uint8)
    bits = (x.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(x.shape[0], -1)[:, :n_hap].to(torch.float32)


class Lists:
    """Each variant's genotype list, as the reference tool builds it for a
    cohort: ``cols[p]`` the list's columns for ploidy profile ``p``
    (sample-major, the second haplotype only where diploid), ``n[p]`` its
    length, ``own`` each row's alt count over its own list."""

    def __init__(self, ds, device, cohort=None):
        self.ds = ds
        self.dev = torch.device(device)
        n_samples = len(ds.panel)
        cohort = np.arange(n_samples) if cohort is None else np.asarray(cohort)
        profiles = (np.full((1, n_samples), 2, dtype=np.uint8)
                    if ds.profiles is None else ds.profiles)
        self.group = (np.zeros(ds.n_variants, dtype=np.int64)
                      if ds.pgroup is None else ds.pgroup.astype(np.int64))
        w = ds.gp.shape[1]
        self.cols, self.n, masks = [], [], []
        for p in range(profiles.shape[0]):
            cols = []
            for s in cohort:
                cols.append(2 * int(s))
                if profiles[p, s] == 2:
                    cols.append(2 * int(s) + 1)
            cols = np.asarray(cols, dtype=np.int64)
            live = np.zeros(w * 8, dtype=np.uint8)
            live[cols] = 1
            self.cols.append(cols)
            self.n.append(int(cols.size))
            masks.append(np.packbits(live))
        self.gp = torch.from_numpy(ds.gp).to(self.dev)
        self.masks = torch.from_numpy(np.stack(masks)).to(self.dev)
        self.group_t = torch.from_numpy(self.group).to(self.dev)
        own = torch.empty(ds.n_variants, dtype=torch.int64, device=self.dev)
        for lo in range(0, ds.n_variants, BLOCK_ROWS):
            hi = min(lo + BLOCK_ROWS, ds.n_variants)
            own[lo:hi] = popcount_rows(
                self.gp[lo:hi] & self.masks[self.group_t[lo:hi]])
        self.own = own

    def lengths(self, rows) -> np.ndarray:
        return np.asarray(self.n)[self.group[rows]]

    def pair_counts(self, i, j) -> np.ndarray:
        """c_ab of the pairs (i[k], j[k]) over their zipped lists."""
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        out = np.zeros(i.size, dtype=np.int64)
        gi, gj = self.group[i], self.group[j]
        for pa in np.unique(gi):
            for pb in np.unique(gj[gi == pa]):
                at = np.flatnonzero((gi == pa) & (gj == pb))
                for lo in range(0, at.size, BLOCK_ROWS):
                    sel = at[lo:lo + BLOCK_ROWS]
                    ti = torch.from_numpy(i[sel]).to(self.dev)
                    tj = torch.from_numpy(j[sel]).to(self.dev)
                    if pa == pb:
                        c = popcount_rows(self.gp[ti] & self.gp[tj]
                                          & self.masks[int(pa)])
                    else:
                        a, b = self._lists(ti, pa, pb), self._lists(tj, pb, pa)
                        c = (a * b).sum(dim=1).to(torch.int64)
                    out[sel] = c.cpu().numpy()
        return out

    def _lists(self, rows: torch.Tensor, p: int, other: int) -> torch.Tensor:
        """float32 lists of ``rows`` (profile ``p``) cut to the walk length
        against profile ``other``."""
        m = min(self.n[int(p)], self.n[int(other)])
        cols = torch.from_numpy(self.cols[int(p)][:m]).to(self.dev)
        return unpack_rows(self.gp[rows], self.ds.n_hap)[:, cols]

    def block_counts(self, rows_i, rows_j, pa, pb) -> torch.Tensor:
        """(len(rows_i), len(rows_j)) c_ab of two contiguous row ranges of
        profiles ``pa`` and ``pb`` (float32 products of 0/1, TF32 off:
        exact)."""
        ti = torch.arange(rows_i.start, rows_i.stop, device=self.dev)
        tj = torch.arange(rows_j.start, rows_j.stop, device=self.dev)
        a, b = self._lists(ti, pa, pb), self._lists(tj, pb, pa)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


# ---- the finish ----------------------------------------------------------

@dataclasses.dataclass
class LD:
    r2: torch.Tensor
    dp: torch.Tensor
    r2_iz: torch.Tensor  # the reference's int 0
    dp_iz: torch.Tensor


def finish(c_ab, c1, c2, n, len1, len2, dtype=torch.float64) -> LD:
    """calc_ld's arithmetic, one operation at a time, in ``dtype``.  Every
    operand is broadcast to a full tensor on one device: PyTorch divides a
    CUDA tensor by a CPU scalar as a product with its reciprocal, which is
    not the correctly rounded quotient."""
    args = (c_ab, c1, c2, n, len1, len2)
    dev = next((x.device for x in args if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    c_ab, c1, c2, n, len1, len2 = torch.broadcast_tensors(
        *(torch.as_tensor(x).to(device=dev, dtype=dtype) for x in args))
    p_ab = c_ab / n
    p1, q1 = c1 / n, (len1 - c1) / n
    p2, q2 = c2 / n, (len2 - c2) / n
    d = p_ab - p1 * p2
    den = torch.where(d >= 0, torch.minimum(p1 * q2, q1 * p2),
                      torch.maximum((-p1) * p2, (-q1) * q2))
    dp_iz = den == 0
    dp = torch.where(dp_iz, torch.zeros_like(d),
                     d / torch.where(dp_iz, torch.ones_like(den), den))
    r2_iz = dp == 0
    r2_den = ((p1 * q1) * p2) * q2
    r2 = torch.where(r2_iz, torch.zeros_like(d),
                     (d * d) / torch.where(r2_iz, torch.ones_like(r2_den),
                                           r2_den))
    return LD(r2=r2, dp=dp, r2_iz=r2_iz, dp_iz=dp_iz)


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype)


def round4(x) -> np.ndarray:
    """Python's ``round(v, 4)`` of each value (float64 out).  rint(v * 1e4)
    agrees with it except within float error of a decimal tie; those
    values are rounded by Python itself."""
    x = _host(x, np.float64)
    y = x * 1e4
    out = np.rint(y) / 1e4
    for k in np.flatnonzero(np.abs(y - np.floor(y) - 0.5) < 1e-6):
        out[k] = round(float(x[k]), 4)
    return out


def measure_k(ld: LD, measure: str) -> torch.Tensor:
    """The thresholded measure rounded as the reference rounds it, as the
    integer k of k / 10^4 (int 0 reads 0), on the device: rint(v * 1e4) is
    exact away from decimal ties, and a value within 1e-6 of a tie is
    rounded by Python."""
    x = ld.r2 if measure == "r_square" else ld.dp
    iz = ld.r2_iz if measure == "r_square" else ld.dp_iz
    y = x.to(torch.float64) * 1e4
    k = torch.round(y)
    risky = (y - torch.floor(y) - 0.5).abs() < 1e-6
    if bool(risky.any()):
        idx = torch.nonzero(risky, as_tuple=True)
        vals = x.to(torch.float64)[idx].cpu().numpy()
        k[idx] = torch.as_tensor([round(round(float(v), 4) * 1e4)
                                  for v in vals],
                                 dtype=torch.float64, device=k.device)
    return torch.where(iz, torch.zeros_like(k), k)


def thres_k(thres: float) -> int:
    """The least k with k / 10^4 >= thres: a rounded value reaches the
    threshold exactly when its k does."""
    k = math.floor(thres * 1e4)
    while k / 1e4 < thres:
        k += 1
    while (k - 1) / 1e4 >= thres:
        k -= 1
    return k


_TABLE = None


def fmt4(values, int_zero) -> list:
    """``str(round(v, 4))`` of each value, '0' where the reference holds
    int 0.  round(v, 4) is the double nearest k / 10^4, which is what
    k / 10_000 gives, so its string is the table's."""
    global _TABLE
    if _TABLE is None:
        _TABLE = np.array([str(k / 10_000) for k in range(-10_000, 10_001)],
                          dtype=object)
    r = round4(values)
    k = np.rint(r * 1e4).astype(np.int64)
    out = _TABLE[np.clip(k, -10_000, 10_000) + 10_000]
    out[(k == 0) & np.signbit(r)] = "-0.0"
    for x in np.flatnonzero(np.abs(k) > 10_000):
        out[x] = str(r[x])
    out[_host(int_zero, bool)] = "0"
    return out.tolist()


# ---- ld_scan -------------------------------------------------------------

@dataclasses.dataclass
class ScanParams:
    measure: str
    thres: float
    max_dist: object  # int or None
    band: int         # rows within which a segment's LD lies
    n_far: int        # sampled pairs farther apart than ``band``


@dataclasses.dataclass
class Hits:
    i: np.ndarray
    j: np.ndarray
    r2: list   # strings as written
    dp: list


def _segments(group: np.ndarray) -> list:
    cuts = np.flatnonzero(np.diff(group)) + 1
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    stops = np.concatenate([cuts, [group.size]]).astype(np.int64)
    return list(zip(starts.tolist(), stops.tolist()))


def _keep_pairs(lists, i, j, prm, dtype):
    """(i, j, LD) of the pairs whose rounded measure reaches the
    threshold (positions within ``max_dist`` already applied)."""
    c_ab = lists.pair_counts(i, j)
    m = np.minimum(lists.lengths(i), lists.lengths(j))
    ld = finish(c_ab, lists.own[torch.from_numpy(i).to(lists.dev)].cpu(),
                lists.own[torch.from_numpy(j).to(lists.dev)].cpu(), m,
                lists.lengths(i), lists.lengths(j), dtype)
    keep = (measure_k(ld, prm.measure) >= thres_k(prm.thres)).numpy()
    return i[keep], j[keep], LD(ld.r2[keep], ld.dp[keep], ld.r2_iz[keep],
                                ld.dp_iz[keep])


def scan_hits(ds, lists: Lists, prm: ScanParams, seed: int,
              dtype=torch.float64):
    """The hits of an ``ld_scan`` of ``ds``: every pair inside one ploidy
    segment within ``band`` rows, every pair across two segments (within
    ``max_dist``), and ``n_far`` pairs of one segment farther apart than
    ``band``, sampled from ``seed``.  Returns (Hits sorted by (i, j), the
    (i, j) pairs the reference looked at outside the band, as a set of
    i * V + j)."""
    v, pos = ds.n_variants, ds.pos
    segs = _segments(lists.group)
    seg_of = np.repeat(np.arange(len(segs)), [b - a for a, b in segs])
    parts = []

    def near(i, j):
        return (np.ones(i.size, bool) if prm.max_dist is None
                else pos[i] - pos[j] <= prm.max_dist)

    for d in range(1, prm.band + 1):
        for lo in range(d, v, BLOCK_ROWS):
            i = np.arange(lo, min(lo + BLOCK_ROWS, v), dtype=np.int64)
            j = i - d
            ok = (seg_of[i] == seg_of[j]) & near(i, j)
            if ok.any():
                parts.append(_keep_pairs(lists, i[ok], j[ok], prm, dtype))

    looked = set()
    rng = np.random.default_rng([seed, 17])
    for a, b in segs:
        n_seg = b - a
        if n_seg <= prm.band + 1 or prm.n_far <= 0:
            continue
        share = max(1, prm.n_far * n_seg // v)
        i = rng.integers(a + prm.band + 1, b, size=share)
        lo_j = np.where(np.arange(share) % 2 == 0,
                        np.maximum(a, i - prm.band - 4096), a)
        j = lo_j + (rng.random(share) * (i - prm.band - lo_j)).astype(np.int64)
        ok = (j < i - prm.band) & near(i, j)
        i, j = i[ok], j[ok]
        looked.update((i * v + j).tolist())
        if i.size:
            parts.append(_keep_pairs(lists, i, j, prm, dtype))

    for sb, (b0, b1) in enumerate(segs):
        for sa in range(sb):
            a0, a1 = segs[sa]
            pa, pb = int(lists.group[a0]), int(lists.group[b0])
            parts.extend(_cross_block_hits(ds, lists, prm, dtype, (b0, b1),
                                           (a0, a1), pb, pa))

    if not parts:
        z = np.zeros(0, np.int64)
        return Hits(z, z, [], []), looked
    i = np.concatenate([p[0] for p in parts])
    j = np.concatenate([p[1] for p in parts])
    r2 = torch.cat([p[2].r2.cpu() for p in parts])
    dp = torch.cat([p[2].dp.cpu() for p in parts])
    r2_iz = torch.cat([p[2].r2_iz.cpu() for p in parts])
    dp_iz = torch.cat([p[2].dp_iz.cpu() for p in parts])
    key = i * v + j
    _, first = np.unique(key, return_index=True)  # a far sample may repeat
    order = first[np.lexsort((j[first], i[first]))]
    return Hits(i[order], j[order], fmt4(r2[order], r2_iz[order]),
                fmt4(dp[order], dp_iz[order])), looked


def _cross_block_hits(ds, lists, prm, dtype, seg_i, seg_j, pi, pj):
    """Hits of every pair (i in seg_i, j in seg_j), i > j, in blocks."""
    pos = ds.pos
    (b0, b1), (a0, a1) = seg_i, seg_j
    if prm.max_dist is not None:
        a0 = max(a0, int(np.searchsorted(pos, pos[b0] - prm.max_dist)))
        b1 = min(b1, int(np.searchsorted(pos, pos[a1 - 1] + prm.max_dist,
                                         side="right")))
    m = min(lists.n[pi], lists.n[pj])
    out = []
    for r0 in range(b0, b1, RECT_ROWS):
        r1 = min(r0 + RECT_ROWS, b1)
        for c0 in range(a0, a1, RECT_COLS):
            c1 = min(c0 + RECT_COLS, a1)
            if (prm.max_dist is not None
                    and pos[r0] - pos[c1 - 1] > prm.max_dist):
                continue
            cab = lists.block_counts(range(r0, r1), range(c0, c1), pi, pj)
            ld = finish(cab, lists.own[r0:r1, None], lists.own[None, c0:c1],
                        m, lists.n[pi], lists.n[pj], dtype)
            keep = measure_k(ld, prm.measure) >= thres_k(prm.thres)
            if prm.max_dist is not None:
                tp = torch.from_numpy(pos).to(cab.device)
                keep &= (tp[r0:r1, None] - tp[None, c0:c1]) <= prm.max_dist
            ii, jj = torch.nonzero(keep, as_tuple=True)
            if ii.numel():
                out.append(((ii + r0).cpu().numpy(), (jj + c0).cpu().numpy(),
                            LD(ld.r2[ii, jj], ld.dp[ii, jj],
                               ld.r2_iz[ii, jj], ld.dp_iz[ii, jj])))
    return out


def scan_header(ds, prm: ScanParams, cohort_text) -> str:
    gends, pops = cohort_text
    return (f'##chr="{ds.chrom}" gends={gends} pops={pops} '
            f"{prm.measure}_thres={prm.thres} max_dist={prm.max_dist}\n"
            "#hg38_pos_1\trsID_1\thg38_pos_2\trsID_2\tdist\tr2\tD'\n")


def scan_body(ds, hits: Hits) -> str:
    """The TSV's hit lines, as ``ld_scan`` writes them."""
    from ldbench.data import RSID_BASE

    pa = ds.pos[hits.i].tolist()
    pb = ds.pos[hits.j].tolist()
    return "".join(
        f"{a}\trs{RSID_BASE + i}\t{b}\trs{RSID_BASE + j}\t{a - b}\t{r}\t{d}\n"
        for a, i, b, j, r, d in zip(pa, hits.i.tolist(), pb, hits.j.tolist(),
                                    hits.r2, hits.dp))


# ---- ld_area -------------------------------------------------------------

@dataclasses.dataclass
class AreaParams:
    measure: str
    thres: float
    flank: int


def area_files(ds, lists: Lists, queries, prm: AreaParams, cohort_text,
               dtype=torch.float64) -> dict:
    """{rsID of a query: its result file's text, or None where it has no
    opponent at the threshold}, as ``ld_area`` writes them (TSV)."""
    from ldbench.data import RSID_BASE

    pos = ds.pos
    q = np.asarray(queries, dtype=np.int64)
    low = np.maximum(pos[q] - prm.flank, 0)
    start = np.searchsorted(pos, low, side="right")
    stop = np.searchsorted(pos, pos[q] + prm.flank, side="right")
    sizes = stop - start
    qi = np.repeat(q, sizes)
    oj = np.concatenate([np.arange(a, b) for a, b in zip(start, stop)]) \
        if q.size else np.zeros(0, np.int64)
    not_self = qi != oj
    qi, oj = qi[not_self], oj[not_self]
    c_ab = lists.pair_counts(qi, oj)
    len_q, len_o = lists.lengths(qi), lists.lengths(oj)
    m = np.minimum(len_q, len_o)
    own = lists.own.cpu().numpy()
    ld = finish(c_ab, own[qi], own[oj], m, len_q, len_o, dtype)
    keep = (measure_k(ld, prm.measure) >= thres_k(prm.thres)).numpy()
    r2s = fmt4(ld.r2[keep], ld.r2_iz[keep])
    dps = fmt4(ld.dp[keep], ld.dp_iz[keep])
    p_o = (torch.as_tensor(own[oj][keep]).to(dtype)
           / torch.as_tensor(m[keep]).to(dtype)).to(torch.float64).numpy()
    gends, pops = cohort_text
    head = (f'##chr="{ds.chrom}" gends={gends} pops={pops} '
            f"each_flank={prm.flank} {prm.measure}_thres={prm.thres}\n"
            "#hg38_pos\trsID\tref\talt\ttype\talt_freq\tr2\tD'\tdist\n")
    rows = {}
    for a, b, r, d, p in zip(qi[keep].tolist(), oj[keep].tolist(), r2s, dps,
                             p_o.tolist()):
        rows.setdefault(a, []).append(
            f"{pos[b]}\trs{RSID_BASE + b}\tA\tG\tSNP\t{round(p, 4)}\t{r}\t{d}"
            f"\t{pos[b] - pos[a]}\n")
    out = {}
    for row in q.tolist():
        rsid = f"rs{RSID_BASE + row}"
        if row not in rows:
            out[rsid] = None
            continue
        p_q = (torch.tensor(float(own[row]), dtype=dtype)
               / torch.tensor(float(lists.lengths([row])[0]), dtype=dtype))
        out[rsid] = (head + f"{pos[row]}\t{rsid}\tA\tG\tSNP\t"
                     f"{round(float(p_q), 4)}\tquer\tquer\tquer\n"
                     + "".join(rows[row]))
    return out


def oracle_line(ds, cohort, i: int, j: int) -> str:
    """The pair (i, j) as the reference tool computes it, in plain Python
    on the two genotype lists: 'r2 D\'' strings (a check of the vector
    path above, for a handful of pairs)."""
    profiles = (np.full((1, len(ds.panel)), 2, dtype=np.uint8)
                if ds.profiles is None else ds.profiles)

    def genotypes(row):
        p = 0 if ds.pgroup is None else int(ds.pgroup[row])
        bits = np.unpackbits(ds.gp[row], count=ds.n_hap).tolist()
        out = []
        for s in np.asarray(cohort).tolist():
            out.append(bits[2 * s])
            if profiles[p, s] == 2:
                out.append(bits[2 * s + 1])
        return out

    a, b = genotypes(i), genotypes(j)
    n = min(len(a), len(b))
    p_ab = sum(1 for x, y in zip(a, b) if x == 1 and y == 1) / n
    p_a, q_a = a.count(1) / n, a.count(0) / n
    p_b, q_b = b.count(1) / n, b.count(0) / n
    d = p_ab - p_a * p_b
    den = min(p_a * q_b, q_a * p_b) if d >= 0 else max(-p_a * p_b, -q_a * q_b)
    d_prime = 0 if den == 0 else d / den
    r_square = 0 if d_prime == 0 else (d ** 2) / (p_a * q_a * p_b * q_b)
    return f"{round(r_square, 4)}\t{round(d_prime, 4)}"

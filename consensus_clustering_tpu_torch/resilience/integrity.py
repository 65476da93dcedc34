"""Silent-corruption defense: sentinels, verified checkpoints, admission.

The port of the reference package's ``resilience/integrity.py``.  Every
parity gate of the port rests on the int32 exactness of the Monti counts;
these checks guard that exactness where corruption enters:

- **Accumulator invariant sentinels** (:func:`build_sentinel`,
  :func:`build_packed_sentinel`): plain tensor functions over the
  streaming engine's state, on the state's device, run every
  ``integrity_check_every`` blocks by the driver.  Valid counts satisfy
  ``0 <= Mij <= Iij <= h_seen``, ``diag(Mij) == diag(Iij)`` and symmetry;
  valid bit-planes cover the co-sampling plane exactly once and hold no
  bit past the resamples run.  A breach raises
  :class:`~.faults.IntegrityError` and the retry resumes from the last
  verified generation.  Each returns int64 scalars, read with one
  ``.tolist()``.
- **Verified checkpoints** (:func:`frame_digest`,
  :func:`verify_state_frame`): numpy only, the reference's functions
  unchanged, so a frame written by either package verifies under both.
- **Input admission** (:func:`check_input_matrix`).

:func:`flip_array_bits` is the ``bitflip`` fault action's hands, on numpy
arrays or torch tensors alike (the same positions for the same seed).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch.ops.bitpack import (
    PACK_BITS,
    packed_width,
    popcount32,
)
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts
from consensus_clustering_tpu_torch.resilience.faults import IntegrityError

__all__ = [
    "INTEGRITY_POINTS",
    "IntegrityError",
    "build_packed_sentinel",
    "build_sentinel",
    "check_input_matrix",
    "flip_array_bits",
    "frame_digest",
    "sentinel_sample_rows",
    "verify_state_frame",
]

#: Detection points an :class:`IntegrityError` can name: only the
#: sentinel's.  A generation refused at resume is recovery, counted as
#: ``verify_rejects``, not an error.
INTEGRITY_POINTS = ("accumulator",)

#: Bit flipped by the fault-injection corruption helpers: bit 30 of an
#: int32 count turns a small exact integer into ~1e9, which violates
#: ``Mij <= Iij <= h_seen`` with certainty (a low-bit flip that keeps the
#: invariants is the corruption no invariant check can see; the digest
#: still catches it on the checkpoint path).
_FLIP_BIT = 30


def _judge(named: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The sentinel's int64 scalars as ints, read in one device sync."""
    values = torch.stack(list(named.values())).tolist()
    return dict(zip(named, values))


# ---------------------------------------------------------------------------
# Accumulator invariant sentinels (tensor functions on the state's device)


def build_sentinel() -> Callable[..., Dict[str, int]]:
    """The dense sentinel: ``(state, h_seen, sample_idx) -> counts``.

    ``state`` is the streaming engine's ``{"mij", "iij"}``; ``h_seen`` the
    resamples accumulated so far; ``sample_idx`` the rows the symmetry
    probe gathers.  Counts, all zero for any state a valid sweep makes:

    - ``range_bad``: elements with ``Mij < 0`` or ``Mij > Iij``
    - ``bound_bad``: elements with ``Iij < 0`` or ``Iij > h_seen``
    - ``diag_bad``: positions where ``diag(Mij) != diag(Iij)``
    - ``sym_bad``: sampled-row positions where ``A[i, :] != A[:, i]``

    The range check loops over K, so no (nK, N, N) temporary exists (at
    N = 5000 and 19 K, Mij alone is 1.9 GB).
    """

    def sentinel(state, h_seen: int, sample_idx) -> Dict[str, int]:
        mij, iij = state["mij"], state["iij"]
        idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64,
                              device=iij.device)
        range_bad = torch.zeros((), dtype=torch.int64, device=iij.device)
        for m in mij:
            range_bad += ((m < 0) | (m > iij)).sum()
        bound_bad = ((iij < 0) | (iij > h_seen)).sum()
        diag_i = torch.diagonal(iij)
        diag_bad = (torch.diagonal(mij, dim1=-2, dim2=-1)
                    != diag_i[None]).sum()
        rows_m = mij[:, idx, :]
        cols_m = mij[:, :, idx].transpose(1, 2)
        sym_bad = (rows_m != cols_m).sum() + (
            iij[idx, :] != iij[:, idx].T).sum()
        return _judge({"range_bad": range_bad, "bound_bad": bound_bad,
                       "diag_bad": diag_bad, "sym_bad": sym_bad})

    return sentinel


def ghost_mask(w_cap: int, hb_pad: int, h_seen: int,
               device=None) -> torch.Tensor:
    """(w_cap,) int32 bit patterns of the bits that must be zero: bit b of
    word w is resample ``(w // wb) * hb_pad + (w % wb) * 32 + b``, live iff
    that resample is < ``h_seen`` and the bit is not block-tail padding.
    Built in int64 and cast, so bit 31 is set by value, never by a
    signed shift of a 1."""
    wb = packed_width(hb_pad)
    w = torch.arange(w_cap, dtype=torch.int64, device=device)
    bit = torch.arange(PACK_BITS, dtype=torch.int64, device=device)
    in_block = (w % wb)[:, None] * PACK_BITS + bit[None, :]
    h_of_bit = (w // wb)[:, None] * hb_pad + in_block
    allowed = (h_of_bit < h_seen) & (in_block < hb_pad)
    live = (allowed.to(torch.int64) << bit[None, :]).sum(dim=1)
    ghost = (~live) & 0xFFFFFFFF
    return torch.where(ghost >= 2**31, ghost - 2**32, ghost).to(torch.int32)


def build_packed_sentinel(
    hb_pad: int, k_max: int
) -> Callable[..., Dict[str, int]]:
    """The packed sentinel over ``{"planes", "coplanes"}`` (int32 words
    holding uint32 bit patterns): ``(state, h_seen, sample_idx) ->
    counts``, all zero for any state a valid sweep makes:

    - ``cover_bad``: words where ``OR_c planes[c] != coplanes`` (a sampled
      element carries a cluster bit, an unsampled one none);
    - ``disjoint_bad``: words where two cluster planes share a bit, the
      positions where ``sum_c popcount(planes[c]) != popcount(OR_c
      planes[c])``, found as a nonzero running ``overlap |= or & p_c``;
    - ``ghost_bad``: set bits at resamples ``>= h_seen`` or in a block's
      tail bits (:func:`ghost_mask`), counted by the port's SWAR popcount;
    - ``range_bad``/``bound_bad``/``diag_bad``: the dense checks on the
      Mij and Iij rows of the sampled indices, popcounted out of the
      planes by :func:`..ops.popcount.packed_coassoc_counts` (kernel B3 on
      the card: one launch for Iij and one per K each check).

    ``hb_pad`` and ``k_max`` are the engine's block geometry.  Padded
    columns and words hold no bits in a valid state, so a bit set there
    shows as ``cover_bad`` or ``ghost_bad``.
    """
    del k_max  # the planes carry it as their second axis

    def sentinel(state, h_seen: int, sample_idx) -> Dict[str, int]:
        planes, cop = state["planes"], state["coplanes"]
        dev = cop.device
        idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64,
                              device=dev)
        ghost = ghost_mask(cop.shape[0], hb_pad, h_seen, dev)[:, None]
        orp = torch.zeros_like(planes[:, 0])
        overlap = torch.zeros_like(orp)
        for c in range(planes.shape[1]):
            overlap |= orp & planes[:, c]
            orp |= planes[:, c]
        cover_bad = (orp != cop[None]).sum()
        disjoint_bad = (overlap != 0).sum()
        ghost_bad = (popcount32(cop & ghost).sum()
                     + popcount32(orp & ghost[None]).sum())
        iij_s = packed_coassoc_counts(cop[:, idx], cop)
        s_ar = torch.arange(idx.shape[0], device=dev)
        diag_i = iij_s[s_ar, idx]
        range_bad = torch.zeros((), dtype=torch.int64, device=dev)
        diag_bad = torch.zeros_like(range_bad)
        for kplanes in planes:
            words = kplanes.reshape(-1, cop.shape[1])
            mij_s = packed_coassoc_counts(words[:, idx], words)
            range_bad += ((mij_s < 0) | (mij_s > iij_s)).sum()
            diag_bad += (mij_s[s_ar, idx] != diag_i).sum()
        bound_bad = ((iij_s < 0) | (iij_s > h_seen)).sum()
        return _judge({"cover_bad": cover_bad, "disjoint_bad": disjoint_bad,
                       "ghost_bad": ghost_bad, "range_bad": range_bad,
                       "bound_bad": bound_bad, "diag_bad": diag_bad})

    return sentinel


def sentinel_sample_rows(n: int, block: int, count: int = 16) -> np.ndarray:
    """Deterministic probe rows for one check: they walk with the block
    (a localised corruption is eventually sampled) and are a pure function
    of (n, block), so a retried run re-checks the same rows."""
    s = max(1, min(int(n), int(count)))
    return (
        (np.arange(s, dtype=np.int64) * 7919 + int(block) * 104729) % int(n)
    ).astype(np.int32)


# ---------------------------------------------------------------------------
# Verified checkpoint frames (host side, numpy only)


def _popcount_u32(a):
    """Vectorised SWAR popcount of a uint32 numpy array (int32 out)."""
    v = np.asarray(a, dtype=np.uint32).copy()
    v -= (v >> np.uint32(1)) & np.uint32(0x55555555)
    v = (v & np.uint32(0x33333333)) + (
        (v >> np.uint32(2)) & np.uint32(0x33333333)
    )
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def frame_digest(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Semantic digest of a checkpoint generation's arrays.

    Per array: shape, dtype, and exact sum/min/max (integers summed in
    int64, floats in float64).  Taken from the pristine host arrays before
    the payload is serialised, so a later payload corruption, even one the
    CRC blesses because it came first, disagrees with the header's digest
    at resume.
    """
    digest: Dict[str, Any] = {}
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        entry: Dict[str, Any] = {
            "shape": [int(v) for v in a.shape],
            "dtype": str(a.dtype),
        }
        if a.size:
            if np.issubdtype(a.dtype, np.integer):
                entry["sum"] = int(np.sum(a, dtype=np.int64))
                entry["min"] = int(a.min())
                entry["max"] = int(a.max())
            else:
                entry["sum"] = float(np.sum(a, dtype=np.float64))
                entry["min"] = float(a.min())
                entry["max"] = float(a.max())
        digest[name] = entry
    return digest


def verify_state_frame(
    header: Dict[str, Any], arrays: Dict[str, Any]
) -> Optional[str]:
    """Why a decoded checkpoint frame must be REFUSED, or None.

    First the semantic digest (payload bytes that changed after it was
    taken), then the accumulator invariants on the state arrays (a frame
    faithfully recording state that was already corrupt).  Packed frames
    carry uint32 planes; frames without a digest verify on invariants
    alone.
    """
    recorded = header.get("digest")
    if recorded is not None:
        fresh = frame_digest(arrays)
        if fresh != recorded:
            changed = sorted(
                name
                for name in set(fresh) | set(recorded)
                if fresh.get(name) != recorded.get(name)
            )
            return f"digest mismatch on {changed}"
    planes = arrays.get("state_planes")
    coplanes = arrays.get("state_coplanes")
    if planes is not None and coplanes is not None:
        planes = np.asarray(planes)
        coplanes = np.asarray(coplanes)
        orp = np.bitwise_or.reduce(planes, axis=1)
        if (orp != coplanes[None]).any():
            return (
                "invariant violation: cluster planes disagree with "
                "the co-sampling plane"
            )
        if (
            _popcount_u32(planes).sum(axis=1) != _popcount_u32(orp)
        ).any():
            return (
                "invariant violation: overlapping cluster planes "
                "(an element in two clusters of one resample)"
            )
        h_done = header.get("h_done")
        hb_pad = header.get("hb_pad")
        if h_done is not None and hb_pad is not None:
            w_cap = coplanes.shape[0]
            wb = -(-int(hb_pad) // 32)
            w = np.arange(w_cap)
            bit = np.arange(32)
            in_block = (w % wb)[:, None] * 32 + bit[None, :]
            live = (
                ((w // wb)[:, None] * int(hb_pad) + in_block)
                < int(h_done)
            ) & (in_block < int(hb_pad))
            ghost = ~np.sum(
                live.astype(np.uint32) << bit[None, :].astype(np.uint32),
                axis=1, dtype=np.uint32,
            )
            if (coplanes & ghost[:, None]).any() or (
                orp & ghost[None, :, None]
            ).any():
                return (
                    "invariant violation: packed state claims "
                    "resamples beyond h_done"
                )
    mij = arrays.get("state_mij")
    iij = arrays.get("state_iij")
    if mij is not None and iij is not None:
        mij = np.asarray(mij)
        iij = np.asarray(iij)
        if (mij < 0).any() or (mij > iij[None, :, :]).any():
            return "invariant violation: Mij outside [0, Iij]"
        h_done = header.get("h_done")
        if (iij < 0).any() or (
            h_done is not None and (iij > int(h_done)).any()
        ):
            return "invariant violation: Iij outside [0, h_done]"
        diag_i = np.diagonal(iij)
        if (np.diagonal(mij, axis1=-2, axis2=-1) != diag_i[None, :]).any():
            return "invariant violation: diag(Mij) != diag(Iij)"
    return None


# ---------------------------------------------------------------------------
# Deterministic corruption (the bitflip fault action's hands)


def flip_array_bits(a, nbits: int, seed: int) -> None:
    """Flip bit 30 at ``nbits`` positions of a contiguous int32 array or
    tensor IN PLACE, deterministically.

    Positions derive from ``seed`` (the block index) alone, drawn without
    replacement (a repeated position would cancel its own flip), the same
    for a numpy array and a torch tensor of the same size, so one fault
    plan makes one corruption on either.
    """
    if isinstance(a, torch.Tensor) and not a.is_contiguous():
        raise ValueError("flip_array_bits needs a contiguous tensor: a "
                         "flattened copy would take the flips")
    flat = a.reshape(-1)
    size = int(flat.shape[0])
    rng = np.random.default_rng(0xC0FFEE + int(seed))
    positions = rng.choice(size, size=min(int(nbits), size), replace=False)
    for pos in positions:
        flat[int(pos)] ^= 1 << _FLIP_BIT


# ---------------------------------------------------------------------------
# Input admission (host side, numpy only)


def check_input_matrix(
    x, max_report: int = 20
) -> Optional[Dict[str, Any]]:
    """Why a data matrix is numerically inadmissible, or None if fine.

    ``reason="non_finite"``: NaN/Inf cells, with the first ``max_report``
    offending ``rows``/``cols`` (NaN is absorbing under the accumulation
    GEMMs: one bad cell poisons whole count rows).  ``reason=
    "zero_variance"``: every row identical, so no K >= 2 partition exists.
    The payload carries ``error``, ``code="invalid_data"`` and ``hint``.
    """
    x = np.asarray(x)
    finite = np.isfinite(x)
    if not finite.all():
        bad_rows, bad_cols = np.nonzero(~finite)
        return {
            "error": (
                f"'data' contains {int((~finite).sum())} non-finite "
                f"value(s) (NaN/Inf); first at row {int(bad_rows[0])}, "
                f"col {int(bad_cols[0])}"
            ),
            "code": "invalid_data",
            "reason": "non_finite",
            "rows": [int(v) for v in np.unique(bad_rows)[:max_report]],
            "cols": [int(v) for v in np.unique(bad_cols)[:max_report]],
            "hint": (
                "NaN is absorbing under the co-clustering accumulation: "
                "one bad cell silently poisons whole count rows. Clean "
                "or impute the listed rows/cols and resubmit"
            ),
        }
    if x.shape[0] > 1 and bool(np.all(x == x[0])):
        return {
            "error": (
                "'data' has zero variance (every row identical): no "
                "clustering into K >= 2 groups is defined"
            ),
            "code": "invalid_data",
            "reason": "zero_variance",
            "rows": [],
            "cols": [],
            "hint": (
                "check the upstream feature pipeline — identical rows "
                "usually mean a join or scaling step emitted a "
                "constant matrix"
            ),
        }
    return None

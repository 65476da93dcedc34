"""Admission-time memory preflight: the byte models of every serve job
mode, the budget they are compared against, and the 413 refusal.

Ported from the reference package's ``serve/preflight.py`` and priced for
the port's own layouts on the card's allocator:

- :func:`estimate_job_bytes`: a streamed dense exact job, whose leading
  term is the int32 state ``4·(nK+1)·N²`` bytes (at N = 10^5 and
  K = 2..20, 800 GB);
- :func:`estimate_packed_bytes`: the packed bit-plane state, ~1/32 of
  it, and the O(N) evaluation tiles;
- :func:`estimate_estimator_bytes`: the sampled-pair estimator's O(M)
  state plus per-block (h_block, N) scatters, and
  :func:`estimate_estimator_sharded`, its per-device share on a mesh;
- :func:`estimate_refine_bytes` and :func:`estimate_append_bytes`: a
  progressive job's refinement and an append (both on the device here,
  where the reference runs them in host numpy);
- :func:`resolve_memory_budget`: the budget in bytes, from an explicit
  value, else ``CCTPU_MEMORY_BUDGET``, else the device's own memory
  (``total_memory`` of a CUDA device; host RAM for the CPU).  Where the
  reference falls back to host RAM when the device query fails, a CUDA
  query that fails here raises: a card's budget is never host RAM;
- :func:`check_admission`: raises :class:`PreflightReject`, whose payload
  is the structured 413 body.

Deliberately simple lower bounds with exact leading terms: if the
estimate alone exceeds the budget, the real run certainly does.  Each
executed job's result holds the estimate beside the allocator's measured
peak (``memory.preflight_accuracy``).
"""


from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence

from consensus_clustering_tpu_torch.estimator.bounds import default_n_pairs

logger = logging.getLogger(__name__)

#: Extra state generations the checkpoint writer can pin at once (the
#: newest host copy, one queued, one serialising).
_CHECKPOINT_PIN_GENERATIONS = 2

ENV_BUDGET = "CCTPU_MEMORY_BUDGET"


class PreflightReject(Exception):
    """The job's estimated footprint exceeds the memory budget (413).

    ``payload`` is the structured body the HTTP layer returns: the
    estimate breakdown, the budget, and the knobs that would shrink the
    job — an actionable refusal, not a bare status code.
    """

    def __init__(self, payload: Dict[str, Any]):
        self.payload = payload
        super().__init__(payload.get("error", "memory preflight reject"))


def estimate_job_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = True,
) -> Dict[str, Any]:
    """Estimated device footprint of one streamed exact job, in bytes:
    each term and ``total_bytes``.  Monotonic in N, |K| and h_block."""
    n = int(n)
    nk = len(tuple(k_values))
    k_max = max(int(k) for k in k_values)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))

    state = 4 * (nk + 1) * n * n
    pin = 1 + (_CHECKPOINT_PIN_GENERATIONS if checkpoints else 0)
    workspace = 8 * n * n
    data = n * d * itemsize
    lanes = 2 * int(h_block) * n_sub * (d + k_max) * itemsize
    total = state * pin + workspace + data + lanes
    return {
        "state_bytes": int(state),
        "pinned_state_generations": int(pin),
        "workspace_bytes": int(workspace),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "total_bytes": int(total),
        "model": "dense int32 accumulators (exact) + f32 consensus "
        "workspace + data + clustering lanes; see serve/preflight.py",
    }


def estimate_packed_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    n_iterations: int = 25,
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = True,
) -> Dict[str, Any]:
    """Estimated device footprint of the PACKED accumulator
    representation (``accum_repr="packed"``) for the same job — the
    ~1/32 twin of :func:`estimate_job_bytes`, and the third footprint
    the 413 admission body discloses (dense vs packed vs estimator).

    The model mirrors ``parallel/streaming.py``'s packed engine:

    - **mask state** — per-K per-cluster uint32 bit-planes, resamples
      packed 32-per-word with whole words per block:
      ``4 · (nK·k_max + 1) · ceil(H/h_block)·ceil(h_block/32) · N``
      bytes (the ``+1`` is the co-sampling plane) — the dense model's
      ``4·(nK+1)·N²`` accumulator term divided by ~``32·N/(H·k_max)``;
      at H·k_max << 32·N this is the whole capacity win.  Checkpoint
      pinning multiplies this term exactly as it does dense state.
    - **tile workspace** — one int32 Iij row tile and one int32 Mij row
      tile of ``min(256, N)`` rows (``parallel/streaming.TILE_ROWS``),
      materialised per evaluation and dropped; on the card the consensus
      tile lives in the histogram kernel's registers:
      ``8 · min(256, N) · N`` bytes — O(N), not O(N²).
    - **block packing scratch** — the per-block plane scatter:
      ``4 · (k_max + 1) · ceil(h_block/32) · N``.
    - **data + clustering lanes** — identical to the dense model
      (shared code, shared cost).

    Unlike the estimator's O(M) path this stays EXACT — bit-identical
    ``Mij``/``Iij`` — which is why it needs ``n_iterations``: the
    packed state is capacity-sized by H.  Monotonic in N, H and |K| by
    construction; NOT in ``h_block`` — each block owns whole words, so
    a smaller block means more tail-padding words (``w_cap`` grows as
    ``h_block`` shrinks below 32) while the lane/scratch terms shrink.
    The preflight's monotonicity pins cover N/H/|K| only.
    """
    n = int(n)
    nk = len(tuple(k_values))
    k_max = max(int(k) for k in k_values)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))
    h = max(1, int(n_iterations))
    hb = max(1, int(h_block))
    w_cap = -(-h // hb) * -(-hb // 32)

    state = 4 * (nk * k_max + 1) * w_cap * n
    pin = 1 + (_CHECKPOINT_PIN_GENERATIONS if checkpoints else 0)
    tile = 8 * min(256, n) * n
    scratch = 4 * (k_max + 1) * -(-hb // 32) * n
    data = n * d * itemsize
    lanes = 2 * hb * n_sub * (d + k_max) * itemsize
    total = state * pin + tile + scratch + data + lanes
    return {
        "state_bytes": int(state),
        "pinned_state_generations": int(pin),
        "tile_workspace_bytes": int(tile),
        "scratch_bytes": int(scratch),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "n_iterations": int(h),
        "total_bytes": int(total),
        "model": "uint32 bit-plane mask state (exact counts at ~1/32 "
        "the dense accumulator bytes) + O(N) row-tile workspace + data "
        "+ clustering lanes; see serve/preflight.py",
    }


def estimate_estimator_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    n_pairs: Optional[int] = None,
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = True,
    accum_repr: str = "dense",
) -> Dict[str, Any]:
    """Estimated device footprint of the sampled-pair estimator for the
    same job: per-K pair counts ``4·(nK+1)·M`` (the only state), the pair
    index arrays, the per-block (h_block, N) label/sample scatters (packed:
    ``ceil(h_block/32)`` words a column), the per-block (h_block, M)
    gathers, data and clustering lanes.  Monotonic in N, M, |K| and
    h_block."""
    n = int(n)
    nk = len(tuple(k_values))
    k_max = max(int(k) for k in k_values)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))
    m = int(n_pairs) if n_pairs else default_n_pairs(n)

    state = 4 * (nk + 1) * m
    pin = 1 + (_CHECKPOINT_PIN_GENERATIONS if checkpoints else 0)
    pairs = 2 * 4 * m
    if accum_repr == "packed":
        scatter = 2 * -(-int(h_block) // 32) * n * (4 + 4)
    else:
        scatter = 2 * int(h_block) * n * (4 + 4)
    pair_workspace = 12 * int(h_block) * m
    data = n * d * itemsize
    lanes = 2 * int(h_block) * n_sub * (d + k_max) * itemsize
    total = state * pin + pairs + scatter + pair_workspace + data + lanes
    return {
        "state_bytes": int(state),
        "pinned_state_generations": int(pin),
        "pair_bytes": int(pairs),
        "scatter_bytes": int(scatter),
        "pair_workspace_bytes": int(pair_workspace),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "n_pairs": int(m),
        "accum_repr": str(accum_repr),
        "total_bytes": int(total),
        "model": "O(M) pair-count state + per-block (h_block, N) "
        "scatters + data + clustering lanes; see serve/preflight.py",
    }


def estimate_refine_bytes(
    n: int,
    d: int,
    k: int,
    n_iterations: int,
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    tile_rows: int = 2048,
) -> Dict[str, Any]:
    """Estimated device footprint of one PROGRESSIVE CONTINUATION, the
    tiled exact refinement of the parent's chosen K
    (:func:`..estimator.tiled.tiled_exact_curves`), so a progressive
    job's 413 body can disclose both phases' footprints at admission.

    The model follows the port's refinement, which runs on the device:
    the (H, n_sub) int64 index and label collection, the packed label
    planes ``4 · (k + 1) · ceil(H/32) · N`` (cluster planes plus the
    co-sampling plane), two int32 (tile_rows, N) count tiles, and the
    data and clustering-lane terms of every other model.  O(H·N/32 +
    tile_rows·N): linear in N where the dense sweep is quadratic.
    ``label_plane_bytes`` is this model's distinguishing key:
    :func:`check_admission` branches its hint on it.
    """
    n = int(n)
    h = max(1, int(n_iterations))
    k_max = int(k)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))

    labels = 2 * 8 * h * n_sub
    planes = 4 * (k_max + 1) * -(-h // 32) * n
    tile = 2 * 4 * min(int(tile_rows), n) * n
    data = n * d * itemsize
    lanes = 2 * int(h_block) * n_sub * (d + k_max) * itemsize
    total = labels + planes + tile + data + lanes
    return {
        "label_bytes": int(labels),
        "label_plane_bytes": int(planes),
        "tile_bytes": int(tile),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "n_iterations": int(h),
        "k": int(k_max),
        "total_bytes": int(total),
        "model": "tiled exact refinement of one K on the device: (H, "
        "n_sub) labels + packed label planes + two (tile_rows, N) int32 "
        "count tiles + data + clustering lanes; see estimator/tiled.py",
    }


def estimate_append_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    n_iterations: int = 25,
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = False,
) -> Dict[str, Any]:
    """Estimated footprint of one ``mode="append"`` job, priced by the
    MARGINAL lanes, which is the point of the append path.

    Two halves, following ``append/engine.py``:

    - **marginal sweep**: the new generation's packed streamed run at
      ``n_iterations`` = the marginal lane budget over the grown N:
      :func:`estimate_packed_bytes` (no ring: a takeover recomputes).
    - **mixing**: ~3 generations of plane bytes at the merge peak (old +
      new + merged; the old generation is priced no larger than the
      merged one), and the merged curves' and the Iij check's int32 (2,048,
      N) count tiles on the device, ``mixing_workspace_bytes``, this
      model's distinguishing key for :func:`check_admission`'s hint.

    Monotonic in N, |K| and the marginal ``n_iterations``.
    """
    packed = estimate_packed_bytes(
        n, d, k_values,
        n_iterations=n_iterations,
        dtype=dtype,
        h_block=h_block,
        subsampling=subsampling,
        checkpoints=checkpoints,
    )
    n = int(n)
    plane_store = 3 * int(packed["state_bytes"])
    mixing = 3 * 4 * min(2048, n) * n
    total = int(packed["total_bytes"]) + plane_store + mixing
    return {
        "marginal_sweep_bytes": int(packed["total_bytes"]),
        "state_bytes": int(packed["state_bytes"]),
        "plane_store_bytes": int(plane_store),
        "mixing_workspace_bytes": int(mixing),
        "data_bytes": int(packed["data_bytes"]),
        "lane_bytes": int(packed["lane_bytes"]),
        "n_iterations": int(max(1, int(n_iterations))),
        "total_bytes": int(total),
        "model": "marginal packed sweep (estimate_packed_bytes at the "
        "marginal lane budget, no ring) + ~3 generations of plane "
        "bytes at the merge peak + (2048, N) int32 count tiles; see "
        "append/engine.py",
    }


def estimate_estimator_sharded(
    estimate: Dict[str, Any], devices: int
) -> Dict[str, Any]:
    """Per-device footprint of the MESH-SHARDED estimator — pure
    arithmetic over an :func:`estimate_estimator_bytes` breakdown, so
    the stdlib-pinned admin path can render it without torch.

    The engine shards lanes over every ('h' × 'n') device and the M
    pair slots over 'n' (estimator/engine.py); the two pure layouts
    trade different terms:

    - ``('h': D, 'n': 1)`` — lanes AND the h-group scatter divide by
      D; the O(M) state replicates.
    - ``('h': 1, 'n': D)`` — lanes, the O(M) state and the pair
      workspace divide by D; the scatter stays whole (the h-group is
      the full block).

    Both are priced (ceil division — conservative) and the smaller
    per-device total wins; its layout is the returned ``mesh`` hint.
    Data replicates either way.  Outputs stay BIT-IDENTICAL across
    layouts (the engine's sharding-invariance gate), so the hint is a
    pure capacity statement — a client refused solo can read it and
    resubmit to a pool where the job fits sharded.
    """
    d = max(1, int(devices))
    state = int(estimate["state_bytes"]) * int(
        estimate["pinned_state_generations"]
    )
    pairs = int(estimate["pair_bytes"])
    scatter = int(estimate["scatter_bytes"])
    pair_ws = int(estimate["pair_workspace_bytes"])
    data = int(estimate["data_bytes"])
    lanes = int(estimate["lane_bytes"])
    h_major = (
        state + pairs + pair_ws + data + -(-(lanes + scatter) // d)
    )
    n_major = (
        -(-(state + pairs + pair_ws) // d)
        + data + -(-lanes // d) + scatter
    )
    if n_major <= h_major:
        mesh = {"h": 1, "n": d}
        per_device = n_major
    else:
        mesh = {"h": d, "n": 1}
        per_device = h_major
    return {
        "devices": d,
        "mesh": mesh,
        "per_device_bytes": int(per_device),
        "model": "estimator/engine.py ('h', 'n') sharding: lanes over "
        "all devices, pair slots over 'n'; outputs bit-identical to "
        "single-device",
    }


def resolve_memory_budget(
    explicit: Optional[int] = None, device=None
) -> Optional[int]:
    """The memory budget in bytes, or None when none can be determined.

    Precedence: ``explicit`` (<= 0: no budget), then the
    ``CCTPU_MEMORY_BUDGET`` environment variable (bytes; a non-integer is
    ignored with a warning), then the device's own memory: a CUDA
    device's ``total_memory`` (``device`` None means ``cuda``; a failed
    query raises), the CPU's physical RAM.
    """
    if explicit is not None:
        return int(explicit) if explicit > 0 else None
    env = os.environ.get(ENV_BUDGET)
    if env:
        try:
            v = int(env)
            return v if v > 0 else None
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", ENV_BUDGET, env)
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(
            os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return None


def check_admission(
    estimate: Dict[str, Any],
    budget_bytes: int,
    shape: Sequence[int],
    estimator: Optional[Dict[str, Any]] = None,
    packed: Optional[Dict[str, Any]] = None,
    continuation: Optional[Dict[str, Any]] = None,
) -> None:
    """Raise :class:`PreflightReject` when the estimate exceeds the
    budget; no-op otherwise.  Split from the estimate so the scheduler
    can count/emit on the reject path with the payload in hand.

    ``estimator`` (the scheduler passes it for exact/auto-mode jobs)
    is the sampled-pair admission path's disclosure — the estimator's
    own predicted footprint, pair count and PAC error bound — attached
    to the 413 body so the refusal carries the resubmission decision's
    whole basis.  ``packed`` is the packed-representation disclosure
    (``accum_repr="packed"``: exact counts at ~1/32 the accumulator
    bytes): with both attached the refusal is a THREE-WAY choice —
    shrink the job, go exact-but-packed, or go estimator-with-bound —
    and a client reads one response and decides without a second
    round-trip (docs/SERVING.md "The 413 -> mode=estimate admission
    path").

    ``continuation`` (the scheduler passes it for progressive jobs) is
    the SECOND phase's footprint — the tiled-refinement model of
    :func:`estimate_refine_bytes`, sized pessimistically at full H —
    attached as pure disclosure: the gate itself compares only
    ``estimate`` (the phase that admits), but the 413 body then prices
    both phases, per the progressive admission contract.
    """
    total = int(estimate["total_bytes"])
    if total <= budget_bytes:
        return
    if "label_plane_bytes" in estimate:
        # The refine-continuation model (estimate_refine_bytes): H·N/32
        # label planes + O(tile_rows·N) tiles — no N² term, no pair
        # sample.
        hint = (
            "shrink iterations (the (H, N/32) label planes and the "
            "(H, n_sub) labels dominate this model) or tile_rows; or "
            "raise the budget "
            "(--memory-budget / CCTPU_MEMORY_BUDGET) if the model is "
            "wrong for your backend"
        )
    elif "n_pairs" in estimate:
        # The gating model is the estimator's O(M) one — there is no
        # N² term to shrink, and pointing at the wrong knobs would
        # have the operator tuning parameters this model ignores.
        hint = (
            "shrink n_pairs (the O(M) pair-count state with its "
            "checkpoint pinning dominates this model), stream_h_block "
            "or the K list; or raise the budget (--memory-budget / "
            "CCTPU_MEMORY_BUDGET) if the model is wrong for your "
            "backend"
        )
        sharded = estimate.get("sharded")
        if sharded and sharded.get("fits_budget"):
            # Refused solo, fits sharded: the estimator's ('h', 'n')
            # mesh sharding is bit-identical, so this is pure capacity.
            hint = (
                f"the job fits mesh-sharded: per-device footprint "
                f"{sharded['per_device_bytes']} bytes over "
                f"{sharded['devices']} devices (mesh hint "
                f"{sharded['mesh']}, outputs bit-identical to "
                "single-device — see estimate.sharded) — or " + hint
            )
    elif "mixing_workspace_bytes" in estimate:
        # The append model (estimate_append_bytes): marginal packed
        # sweep + host-side generation mixing — no dense N² accumulator,
        # no pair sample.
        hint = (
            "shrink iterations (the marginal lane budget sizes the new "
            "generation's bit-plane state) or the K list; the N² "
            "mixing workspace shrinks only with N; or raise the budget "
            "(--memory-budget / CCTPU_MEMORY_BUDGET) if the model is "
            "wrong for your backend"
        )
    elif "tile_workspace_bytes" in estimate:
        # Packed-representation gate: the mask state is O(nK·k·H·N/32)
        # and the workspace O(N) — the dense hint's "N² accumulator"
        # knobs don't exist here.
        hint = (
            "shrink N, iterations (the bit-plane mask state scales "
            "with H), or the K list; or raise the budget "
            "(--memory-budget / CCTPU_MEMORY_BUDGET) if the model is "
            "wrong for your backend"
        )
    else:
        hint = (
            "shrink N (the N² accumulator term dominates), the K "
            "list, or stream_h_block; or raise the budget "
            "(--memory-budget / CCTPU_MEMORY_BUDGET) if the model "
            "is wrong for your backend"
        )
    if estimator is not None and estimator.get("fits_budget"):
        hint = (
            "resubmit with config.mode = 'estimate' (or 'auto'): the "
            "sampled-pair estimator fits this budget and returns PAC "
            "with the disclosed error bound in the 'estimator' field "
            "— or " + hint
        )
    if packed is not None and packed.get("fits_budget"):
        # Prepended LAST so it leads the hint: the packed
        # representation keeps EXACT counts — same statistic, no error
        # band, just a different accumulator layout — so it outranks
        # the estimator in the recommendation ordering.
        hint = (
            "resubmit with config.accum_repr = 'packed': the "
            "bit-plane representation keeps exact counts at ~1/32 the "
            "accumulator bytes and fits this budget (see the 'packed' "
            "field) — or " + hint
        )
    payload = {
        "error": (
            f"memory preflight: job at shape {list(shape)} needs an "
            f"estimated {total} bytes but the backend budget is "
            f"{budget_bytes} bytes — admitting it would OOM every "
            "in-flight job"
        ),
        "estimated_bytes": total,
        "budget_bytes": int(budget_bytes),
        "estimate": dict(estimate),
        "hint": hint,
    }
    if estimator is not None:
        payload["estimator"] = dict(estimator)
    if packed is not None:
        payload["packed"] = dict(packed)
    if continuation is not None:
        payload["continuation"] = dict(continuation)
    raise PreflightReject(payload)

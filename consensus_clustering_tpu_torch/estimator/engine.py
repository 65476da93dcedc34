"""The sampled-pair consensus engine: O(M) state, any N.

The port of the reference package's ``estimator/engine.py``.  PAC needs
only the CDF of the consensus values over the upper triangle's pair
population, and a uniform sample of M pairs estimates a CDF with a
distribution-free band (:mod:`.bounds`).  The engine streams the resample
blocks of the streaming engine and keeps counts for the M sampled pairs
only (:mod:`.sampler`):

- **Pair-exact counts.**  The block draws its plan through
  :func:`..ops.resample.resample_indices` with global resample ids and its
  labels through :func:`..parallel.sweep.resample_lane_keys` and
  :func:`..parallel.sweep.fit_resample_lanes`, as
  :class:`..parallel.streaming.StreamingSweep` does, so every sampled
  pair's ``mij``/``iij`` equals the dense engines' matrix entry bit for
  bit; the only approximation is which pairs were sampled.
- **O(M) state.**  ``mij`` (nK, M) and ``iij`` (M,) int32 on the device.
  A block holds one (h_block, N) label scatter (dense pair path) or the
  block's (k_max, ceil(h_block/32), N) bit-planes (packed pair path,
  ``accum_repr="packed"``: a pair's increment is the popcount of two
  words ANDed, summed over words and clusters); nothing N x N.
- **The streaming driver's contract.**  H is a runtime argument; the
  adaptive early stop, block callbacks, the O(M) integrity sentinel, the
  ``block_start`` and ``accumulator`` fault points and block checkpoints
  on the :class:`..resilience.blocks.StreamCheckpointer` ring, under the
  estimator's own fingerprint (:func:`..utils.checkpoint.
  estimator_stream_fingerprint`), resumed bit for bit.

- **On an ('h', 'n') mesh** (reference ``local_step``): a block's lanes
  split over every shard as in the streaming engine, the pair slots over
  'n' (``m_local`` each, padded to ``m_pad = m_local * n_r`` with the
  throwaway pair (0, 0), masked out of every curve and cropped from every
  frame and ``pair_state``); each shard counts its slots over its 'h'
  row's resamples (the row's labels gathered along 'n'), the increments
  are summed over 'h' and each K's histogram counts over 'n'.  Every
  merge is an integer sum, so every mesh gives the one-device counts bit
  for bit, and a frame resumes under any mesh with the same padded block.
  A 'k' axis is refused (the per-K state is M-sized).  Across processes
  ('h' or 'n' spanning them) the merges run in the groups of the
  processes they span, every process ends with the same counts, and the
  ring follows the stream's rules (:class:`..parallel.streaming.
  RingRole`: the primary reads and writes, a resume is broadcast; the
  sentinel's verdict is agreed over the processes).

The per-pair AND, popcount, gathers and the masked histogram are XLA ops
in the reference and plain torch ops here; the clusterer runs the port's
kernels (B2 and the final assignment on the card).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.estimator.bounds import (
    DEFAULT_DELTA,
    bound_disclosure,
    default_n_pairs,
)
from consensus_clustering_tpu_torch.estimator.sampler import (
    pair_key,
    sample_pairs,
)
from consensus_clustering_tpu_torch.models.protocol import Clusterer
from consensus_clustering_tpu_torch.ops import launch_counts
from consensus_clustering_tpu_torch.ops.analysis import (
    device_scalar,
    masked_histogram_counts,
)
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
    packed_width,
    popcount32,
)
from consensus_clustering_tpu_torch.ops.resample import resample_indices
from consensus_clustering_tpu_torch.parallel.mesh import (
    KSHARD_AXIS,
    RESAMPLE_AXIS,
    Mesh,
    engine_mesh,
)
from consensus_clustering_tpu_torch.parallel.streaming import (
    RingRole,
    adaptive_decision,
    agree_counts,
)
from consensus_clustering_tpu_torch.parallel.sweep import (
    DeviceCopies,
    _shard_labels,
    gather_lines,
    build_kernels,
    launches_since,
    local_column,
    per_device_memory,
    row_lanes,
    shard_lanes,
    sweep_geometry,
    valid_lanes,
)
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)
from consensus_clustering_tpu_torch.resilience.faults import (
    IntegrityError,
    faults,
)
from consensus_clustering_tpu_torch.resilience.integrity import (
    flip_array_bits,
    frame_digest,
)
from consensus_clustering_tpu_torch.utils.checkpoint import (
    backend_tag,
    data_fingerprint,
    estimator_stream_fingerprint,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    in_peak_memory_window,
)


def verify_pair_state_frame(
    header: Dict[str, Any], arrays: Dict[str, Any]
) -> Optional[str]:
    """Why a pair-engine checkpoint frame must be REFUSED, or None.

    The semantic digest the writer embedded, then the count invariants
    ``0 <= mij <= iij <= h_done`` elementwise on the (nK, M)/(M,) counts
    (pairs are strictly upper-triangle: no diagonal clause).
    """
    recorded = header.get("digest")
    if recorded is not None:
        fresh = frame_digest(arrays)
        if fresh != recorded:
            changed = sorted(
                name for name in set(fresh) | set(recorded)
                if fresh.get(name) != recorded.get(name)
            )
            return f"digest mismatch on {changed}"
    mij = arrays.get("state_mij")
    iij = arrays.get("state_iij")
    if mij is not None and iij is not None:
        mij = np.asarray(mij)
        iij = np.asarray(iij)
        if (mij < 0).any() or (mij > iij[None, :]).any():
            return "invariant violation: pair mij outside [0, iij]"
        h_done = header.get("h_done")
        if (iij < 0).any() or (
            h_done is not None and (iij > int(h_done)).any()
        ):
            return "invariant violation: pair iij outside [0, h_done]"
    return None


def estimate_curves_from_pair_counts(
    counts: np.ndarray,
    m: int,
    n: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
):
    """(hist, cdf, pac_area) estimates from per-K sampled-pair bin counts
    (nK, bins), on the host: the empirical pair CDF ``cumsum(counts)/M``,
    with the parity zeros' exact affine map (``N(N+1)/2`` structural zeros
    over an N^2 denominator).  float32 curves, ``pac_area`` from the f32
    CDF, as the reference."""
    counts = np.asarray(counts, dtype=np.int64)
    bins = counts.shape[-1]
    m = float(int(m))
    n = int(n)
    t = n * (n - 1) / 2.0
    f_pairs = np.cumsum(counts, axis=-1) / m
    est_counts = counts / m * t
    if parity_zeros:
        total = float(n) * float(n)
        cdf = (t * f_pairs + n * (n + 1) / 2.0) / total
        est_counts = est_counts.copy()
        est_counts[..., 0] += n * (n + 1) / 2.0
    else:
        total = t
        cdf = f_pairs
    dbin = 1.0 / bins
    hist = (est_counts / (total * dbin)).astype(np.float32)
    cdf = cdf.astype(np.float32)
    pac = cdf[..., pac_hi_idx - 1] - cdf[..., pac_lo_idx]
    return hist, cdf, np.asarray(pac, dtype=np.float32)


class PairConsensusEngine:
    """The pair-count block step on a mesh (default one device) plus its
    host driver.

    Build once per (shape, mesh, config-minus-H, n_pairs) and call
    :meth:`run` for any ``n_iterations``.
    """

    def __init__(
        self,
        clusterer: Clusterer,
        config: SweepConfig,
        n_pairs: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        device=None,
    ):
        if config.stream_h_block is None:
            raise ValueError(
                "PairConsensusEngine needs SweepConfig.stream_h_block "
                "(the resamples-per-block size)"
            )
        if config.store_matrices:
            raise ValueError(
                "the pair estimator never materialises matrices; pass "
                "store_matrices=False (it has nothing N×N to store)"
            )
        self.mesh = engine_mesh(mesh, device)
        if self.mesh.shape[KSHARD_AXIS] != 1:
            raise ValueError(
                "the pair estimator shards its lane work over the "
                "('h', 'n') mesh axes only — the per-K state is M-sized "
                "(a megabyte), so a 'k' axis would shard nothing that "
                "matters; build the mesh with k_shards=1 and give the "
                "devices to 'h'/'n'"
            )
        self.config = config
        self.clusterer = clusterer
        self.device = self.mesh.primary
        self.n_pairs = int(
            n_pairs if n_pairs is not None
            else default_n_pairs(config.n_samples)
        )
        if self.n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {self.n_pairs}")
        self._geo = sweep_geometry(config, self.mesh, config.stream_h_block)
        self._hb = self._geo.h_pad
        self._n_ks = len(config.k_values)
        self._packed = config.accum_repr == "packed"
        self._m_local = -(-self.n_pairs // self._geo.n_r)
        self._group_hb = self._geo.n_r * self._geo.local_h
        self._wb = packed_width(self._group_hb)

    # -- state -----------------------------------------------------------

    def init_state(self) -> Dict[str, Dict[int, torch.Tensor]]:
        """Zeroed int32 pair-count shards on their devices: ``mij`` (nK,
        m_local) and ``iij`` (m_local,) per row shard r this process
        keeps."""
        out = {"mij": {}, "iij": {}}
        for r in self.mesh.held_rows(0):
            dev = self.mesh.device(self.mesh.row_owner(0, r))
            out["mij"][r] = torch.zeros((self._n_ks, self._m_local),
                                        dtype=torch.int32, device=dev)
            out["iij"][r] = torch.zeros((self._m_local,), dtype=torch.int32,
                                        device=dev)
        return out

    def gather_state(self, state) -> Dict[str, torch.Tensor]:
        """The counts of the M sampled pairs, padding slots cropped, on
        the primary device: ``mij`` (nK, M) and ``iij`` (M,).  Collective
        across processes: every process gets them."""
        m = self.n_pairs
        return {name: self.mesh.merge_rows(0, state[name], dim=dim,
                                           dest=self.device)[..., :m]
                for name, dim in (("mij", 1), ("iij", 0))}

    def _load_state(self, state, flat: Dict[str, torch.Tensor]) -> None:
        """Write :meth:`gather_state`-shaped counts into the shards."""
        m, ml = self.n_pairs, self._m_local
        for name, value in flat.items():
            for r, shard in state[name].items():
                lo, hi = r * ml, min(m, (r + 1) * ml)
                if hi > lo:
                    shard[..., :hi - lo].copy_(value[..., lo:hi])

    def pairs_for_seed(self, seed: int):
        """The (pair_i, pair_j) int64 sample of a run seed, on the device."""
        return sample_pairs(pair_key(seed, self.device),
                            self.config.n_samples, self.n_pairs)

    def _pair_shards(self, pair_i, pair_j):
        """Each row shard's (pair_i, pair_j, slot mask) on its devices:
        padding slots hold the pair (0, 0), masked out."""
        m, ml = self.n_pairs, self._m_local
        pad = ml * self._geo.n_r - m
        if pad:
            zeros = pair_i.new_zeros(pad)
            pair_i, pair_j = torch.cat([pair_i, zeros]), torch.cat(
                [pair_j, zeros])
        valid = torch.arange(ml * self._geo.n_r, device=pair_i.device) < m
        out = {}
        for c in self.mesh.coords():
            if self.mesh.is_local(c):
                sl = slice(c[2] * ml, (c[2] + 1) * ml)
                dev = self.mesh.device(c)
                out[c] = tuple(t[sl].to(dev) for t in (pair_i, pair_j,
                                                        valid))
        return out

    def warmup(self) -> float:
        """Build the CUDA kernels (nothing on the CPU); returns seconds."""
        return build_kernels(self.device)

    # -- the block step --------------------------------------------------

    def _scatter(self, indices, values) -> torch.Tensor:
        """(rows, N) int32 with ``values`` at each row's sampled columns, 0
        elsewhere (padding rows hold -1 indices: dropped)."""
        hb = indices.shape[0]
        rows = torch.arange(hb, device=indices.device)[:, None].expand_as(
            indices)
        valid = indices >= 0
        out = torch.zeros((hb, self.config.n_samples), dtype=torch.int32,
                          device=indices.device)
        out[rows[valid], indices[valid]] = values[valid].to(torch.int32)
        return out

    def _iij_increment(self, indices, pair_i, pair_j) -> torch.Tensor:
        """(m_local,) int32: the rows' resamples holding both ends of a
        pair."""
        if self._packed:
            coplane = pack_cosample_planes(indices, self.config.n_samples,
                                           n_words=self._wb)
            anded = coplane[:, pair_i] & coplane[:, pair_j]
            return popcount32(anded).sum(0).to(torch.int32)
        samp = self._scatter(indices, torch.ones_like(indices))
        return (samp[:, pair_i] * samp[:, pair_j]).sum(0, dtype=torch.int32)

    def _mij_increment(self, labels, indices, pair_i, pair_j) -> torch.Tensor:
        """(m_local,) int32: the rows' resamples clustering both ends of a
        pair together."""
        if self._packed:
            # Every cluster's plane at once; the reference builds the same
            # words one cluster at a time.
            planes = pack_label_planes(labels, indices, self.config.k_max,
                                       self.config.n_samples,
                                       n_words=self._wb)
            anded = planes[:, :, pair_i] & planes[:, :, pair_j]
            return popcount32(anded).sum((0, 1)).to(torch.int32)
        # label + 1 scatter: 0 = not sampled, >= 1 = cluster.
        labmat = self._scatter(indices, labels + 1)
        li, lj = labmat[:, pair_i], labmat[:, pair_j]
        return ((li > 0) & (li == lj)).sum(0, dtype=torch.int32)

    def step(self, state, x, pairs, key, h_start: int,
             h_total: int) -> torch.Tensor:
        """One block: adds its counts to ``state`` in place; returns the
        (nK, bins) int32 histogram counts of every K's sampled-pair
        consensus so far.  ``pairs`` is :meth:`_pair_shards` of the run's
        sample."""
        config, geo, mesh = self.config, self._geo, self.mesh
        on = DeviceCopies(mesh)
        pair = rng.split(key)
        key_resample, key_cluster = pair[0], pair[1]
        indices = resample_indices(key_resample, config.n_samples, self._hb,
                                   config.n_sub, h_start=h_start)
        indices[max(0, min(self._hb, h_total - h_start)):] = -1

        def rows(c):
            return on(indices, c)[row_lanes(geo, c[1])]

        cons_div = {}
        held = mesh.held_rows(0)
        for r in held:
            parts = {c: self._iij_increment(rows(c), *pairs[c][:2])
                     for c in local_column(mesh, 0, r)}
            state["iij"][r] += mesh.psum(
                parts, mesh.axis((0, 0, r), RESAMPLE_AXIS))
            cons_div[r] = state["iij"][r].to(torch.float32) + device_scalar(
                1e-6, state["iij"][r].device)
        x_sub = {c: on(x, c)[on(indices, c)[shard_lanes(geo, c)]
                             [:valid_lanes(geo, c, h_total, h_start)]]
                 for c in mesh.coords() if mesh.is_local(c)}
        counts = []
        for i, k in enumerate(config.k_values):
            labels = {c: _shard_labels(self.clusterer, config, geo, c,
                                       on(key_cluster, c), k, xs, h_total,
                                       h_start)
                      for c, xs in x_sub.items()}
            lines = gather_lines(mesh, labels, 0)
            hist = {}
            for r in held:
                parts = {}
                for c in local_column(mesh, 0, r):
                    group = lines[c[1]].to(mesh.device(c), non_blocking=True)
                    parts[c] = self._mij_increment(group, rows(c),
                                                   *pairs[c][:2])
                mij = state["mij"][r][i]
                mij += mesh.psum(parts, mesh.axis((0, 0, r), RESAMPLE_AXIS))
                # The dense consensus arithmetic at the sampled pairs: an
                # f32 divide with the 1e-6 regulariser (pairs are i < j: no
                # diagonal); padding slots are masked out.
                o = mesh.row_owner(0, r)
                cons = mij.to(torch.float32) / cons_div[r]
                hist[r] = masked_histogram_counts(
                    cons[None, :], pairs[o][2][None, :], config.bins)
            counts.append(mesh.merge_rows(0, hist, dest=self.device))
        return torch.stack(counts)

    # -- resilience ------------------------------------------------------

    @staticmethod
    def _integrity_stats(flat, h_seen: int) -> Dict[str, int]:
        """The O(M) invariant sentinel on :meth:`gather_state`'s counts:
        violations of ``0 <= mij <= iij`` and ``0 <= iij <= h_seen``, all
        zero for a valid state."""
        mij, iij = flat["mij"], flat["iij"]
        range_bad = ((mij < 0) | (mij > iij[None, :])).sum()
        bound_bad = ((iij < 0) | (iij > h_seen)).sum()
        return {"range_bad": int(range_bad), "bound_bad": int(bound_bad)}

    def _flip_state_bits(self, state, nbits: int, block: int) -> None:
        """The ``accumulator`` bitflip fault on ``mij``, in place: the real
        slots of this process's first shard (on one device, every pair),
        with no merge, as a plan may arm one process only (reached only
        when a fault plan armed it)."""
        r, shard = sorted(state["mij"].items())[0]
        live = shard[:, :max(0, min(self._m_local,
                                    self.n_pairs - r * self._m_local))]
        host = live.cpu().numpy().copy()
        flip_array_bits(host, nbits, seed=block)
        live.copy_(torch.from_numpy(host))

    def _verify_frame(self, header, arrays) -> Optional[str]:
        """:func:`verify_pair_state_frame` after the counts' shapes are
        checked against this engine's (nK, M)."""
        shapes = {"state_mij": (self._n_ks, self.n_pairs),
                  "state_iij": (self.n_pairs,)}
        for name, shape in shapes.items():
            got = arrays.get(name)
            if got is None or tuple(got.shape) != shape:
                return f"{name} is not a {shape} array for this engine"
        return verify_pair_state_frame(header, arrays)

    # -- the driver ------------------------------------------------------

    @in_peak_memory_window
    def run(
        self,
        x: np.ndarray,
        seed: int,
        n_iterations: int,
        block_callback: Optional[Callable[[int, int, List[float]], None]] = None,
        adaptive_tol: Optional[float] = None,
        adaptive_patience: Optional[int] = None,
        adaptive_min_h: Optional[int] = None,
        checkpointer: Optional[StreamCheckpointer] = None,
        integrity_check_every: Optional[int] = None,
        return_state: bool = False,
    ) -> Dict[str, Any]:
        """Stream the estimator; returns the streaming engine's result
        schema (``hist``, ``cdf``, ``pac_area``, ``streaming``, ``timing``)
        plus ``estimator``, the disclosed bound
        (:func:`.bounds.bound_disclosure`).

        The knobs are :meth:`..parallel.streaming.StreamingSweep.run`'s.
        ``checkpointer`` resumes a run of the same (config, seed, data,
        backend, H, knobs, n_pairs) bit for bit; frames hold the (nK, M)
        counts and curves.  ``return_state`` adds ``pair_state``: the
        pairs and their final counts, host int arrays.
        """
        config = self.config
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        if adaptive_tol is None:
            adaptive_tol = config.adaptive_tol
        if adaptive_patience is None:
            adaptive_patience = config.adaptive_patience
        if adaptive_min_h is None:
            adaptive_min_h = config.adaptive_min_h
        if integrity_check_every is None:
            integrity_check_every = config.integrity_check_every
        integrity_check_every = int(integrity_check_every)
        if integrity_check_every < 0:
            raise ValueError(
                f"integrity_check_every must be >= 0, got "
                f"{integrity_check_every}"
            )
        adaptive = adaptive_tol is not None
        lo, hi = config.pac_idx
        n, m, hb = config.n_samples, self.n_pairs, self._hb
        device = self.device
        on_cuda = device.type == "cuda"
        launches0 = launch_counts()
        t0 = time.perf_counter()
        xd = torch.as_tensor(np.asarray(x)).to(device=device,
                                               dtype=config.torch_dtype)
        key = rng.prng_key(seed, device)
        pair_i, pair_j = self.pairs_for_seed(seed)
        pairs = self._pair_shards(pair_i, pair_j)
        n_blocks = -(-n_iterations // hb)
        trajectory: List[List[float]] = []
        prev_pac = None
        quiet = 0
        stopped_early = False
        curves: Dict[str, np.ndarray] = {}
        h_effective = 0
        start_block = 0
        resume_terminal = False
        state = None
        ring = RingRole(self.mesh, checkpointer)
        if ring.on:
            ckpt_fp = estimator_stream_fingerprint(
                config, seed, data_fingerprint(np.asarray(x)),
                backend=backend_tag(device), n_pairs=m,
                n_iterations=n_iterations, adaptive_tol=adaptive_tol,
                adaptive_patience=adaptive_patience,
                adaptive_min_h=adaptive_min_h,
            )
            resume = ring.latest(ckpt_fp, self._verify_frame)
            if resume is not None:
                header, arrays = resume
                state = self.init_state()
                self._load_state(state, {
                    name: torch.from_numpy(np.ascontiguousarray(
                        arrays[f"state_{name}"])).to(device)
                    for name in ("mij", "iij")})
                trajectory = [[float(v) for v in row]
                              for row in header["trajectory"]]
                if trajectory:
                    prev_pac = np.asarray(trajectory[-1], dtype=np.float32)
                quiet = int(header["quiet"])
                h_effective = int(header["h_done"])
                curves = {name[len("curve_"):]: arrays[name]
                          for name in arrays if name.startswith("curve_")}
                start_block = int(header["block_index"]) + 1
                ring.resumed()
                stopped_early = bool(header.get("stopped", False))
                resume_terminal = stopped_early or h_effective >= n_iterations
                if not resume_terminal and h_effective != start_block * hb:
                    raise ValueError(
                        f"checkpoint frame h_done={h_effective} (writer "
                        f"h_block_padded="
                        f"{header.get('h_block_padded', 'unknown')}) does "
                        f"not align with this engine's block of {hb}; "
                        "resume with the same stream_h_block, or point the "
                        "run at a fresh checkpoint ring"
                    )
        if state is None:
            state = self.init_state()
        integrity_checks = 0

        def check_due(b: int) -> bool:
            if integrity_check_every <= 0:
                return False
            return adaptive or (
                b % integrity_check_every == integrity_check_every - 1
                or b == n_blocks - 1
            )

        try:
            for b in range(start_block, start_block if resume_terminal
                           else n_blocks):
                faults.fire("block_start", index=b)
                counts = self.step(state, xd, pairs, key, b * hb,
                                   n_iterations)
                h_done = min((b + 1) * hb, n_iterations)
                nbits = faults.corrupt("accumulator", index=b)
                if nbits:
                    self._flip_state_bits(state, nbits, b)
                if check_due(b):
                    integrity_checks += 1
                    found = agree_counts(self.mesh, self._integrity_stats(
                        self.gather_state(state), h_done))
                    bad = {name: v for name, v in found.items() if v}
                    if bad:
                        raise IntegrityError(
                            "accumulator",
                            f"pair-count sentinel: block {b} state violates "
                            f"the count invariants ({bad}): corrupt "
                            "accumulator; retry from the last verified "
                            "checkpoint",
                            block=b, details=bad,
                            checks_run=integrity_checks,
                        )
                hist, cdf, pac = estimate_curves_from_pair_counts(
                    counts.cpu().numpy(), m, n, lo, hi,
                    parity_zeros=config.parity_zeros,
                )
                curves = {"hist": hist, "cdf": cdf, "pac_area": pac}
                h_effective = h_done
                trajectory.append([float(v) for v in pac])
                if block_callback is not None:
                    block_callback(b, h_effective, trajectory[-1])
                stop = False
                if adaptive:
                    quiet, stop = adaptive_decision(
                        prev_pac, pac, quiet, adaptive_tol,
                        adaptive_patience, adaptive_min_h, h_effective,
                        n_iterations,
                    )
                prev_pac = pac
                flat = self.gather_state(state) if ring.on else None
                if ring.writer:
                    # Copies: the next block updates the state in place.
                    arrays = {f"state_{name}":
                              value.to("cpu", copy=True).numpy()
                              for name, value in flat.items()}
                    arrays.update({f"curve_{name}": v
                                   for name, v in curves.items()})
                    checkpointer.write_async({
                        "fingerprint": ckpt_fp,
                        "block_index": int(b),
                        "h_done": int(h_effective),
                        "n_iterations": int(n_iterations),
                        "trajectory": [list(row) for row in trajectory],
                        "quiet": int(quiet),
                        "stopped": bool(stop),
                        "h_block_padded": int(hb),
                        "written_at": round(time.time(), 3),
                    }, arrays)
                if stop:
                    stopped_early = True
                    break
        except BaseException as e:
            try:
                e.integrity_checks_run = integrity_checks
            except Exception:  # noqa: BLE001 -- never mask the failure
                pass
            raise
        finally:
            if checkpointer is not None:
                checkpointer.flush()
        out: Dict[str, Any] = dict(curves)
        if return_state:
            flat = self.gather_state(state)
            out["pair_state"] = {
                "pair_i": pair_i.cpu().numpy(),
                "pair_j": pair_j.cpu().numpy(),
                "mij": flat["mij"].cpu().numpy(),
                "iij": flat["iij"].cpu().numpy(),
            }
        for dev in self.mesh.local_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        run_seconds = time.perf_counter() - t0
        del state
        out["streaming"] = {
            "h_block": int(config.stream_h_block),
            "h_block_padded": int(hb),
            "h_requested": int(n_iterations),
            "h_effective": int(h_effective),
            "n_blocks_run": len(trajectory),
            "stopped_early": stopped_early,
            "pac_trajectory": trajectory,
            "resumed_from_block": int(start_block),
            "checkpoint_writes": ring.writes(),
            "integrity_checks": int(integrity_checks),
            "integrity_check_every": int(integrity_check_every),
            "accum_repr": config.accum_repr,
        }
        out["estimator"] = bound_disclosure(
            m, n, parity_zeros=config.parity_zeros, delta=DEFAULT_DELTA)
        out["timing"] = {
            "run_seconds": run_seconds,
            "resamples_per_second": h_effective * self._n_ks / max(
                run_seconds, 1e-9),
            "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
            "device_memory": device_memory_stats(device) if on_cuda else {},
            "device_memory_per_device": per_device_memory(self.mesh),
            "kernel_launches": launches_since(launches0),
            "mesh": dict(self.mesh.shape),
            "processes": self.mesh.process_count,
        }
        return out


def run_pair_estimate(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    n_pairs: Optional[int] = None,
    mesh=None,
    device=None,
    block_callback=None,
    checkpointer: Optional[StreamCheckpointer] = None,
) -> Dict[str, Any]:
    """Build the engine and the kernels and stream ``config``'s H: the
    estimator's :func:`..parallel.streaming.run_streaming_sweep`
    (``timing`` adds ``compile_seconds``)."""
    engine = PairConsensusEngine(clusterer, config, n_pairs=n_pairs,
                                 mesh=mesh, device=device)
    compile_seconds = engine.warmup()
    out = engine.run(x, seed, config.n_iterations,
                     block_callback=block_callback,
                     checkpointer=checkpointer)
    out["timing"]["compile_seconds"] = compile_seconds
    return out

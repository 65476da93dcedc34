"""The port's resilience layer against the reference package's.

- Sentinels: the port's dense and packed sentinels give exactly the
  reference's violation counts on the same state (a reference
  ``StreamingSweep`` ring's frame converted with ``convert.state_from_jax``),
  clean, after ``flip_array_bits`` at 3 seeds, at a ragged N, with a block
  that is not a multiple of 32, and with a bit set only in the padding.
- ``sentinel_sample_rows``, ``frame_digest`` and ``verify_state_frame``
  equal the reference's functions; frames cross-decode and verify between
  the packages both ways.
- Fingerprints: never the reference's, one per backend, blind to the same
  knobs and sensitive to the same fields.
- The ring, the fault grammar and ``classify_error`` behave as the
  reference's do (``tests/test_resilience.py``).
- Kill-and-resume and bitflip recovery give every output of an
  uninterrupted run bit for bit; the API resumes per K and per block and
  calls ``progress_callback`` once per K.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.parallel.streaming import (
    StreamingSweep as JaxStreamingSweep,
)
from consensus_clustering_tpu.resilience import blocks as jax_blocks
from consensus_clustering_tpu.resilience.faults import faults as jax_faults
from consensus_clustering_tpu.resilience import integrity as jax_integrity
from consensus_clustering_tpu.utils import checkpoint as jax_checkpoint
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import state_from_jax
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.resilience import (
    FaultInjector,
    InjectedFault,
    InjectedOOM,
    IntegrityError,
    StreamCheckpointer,
    classify_error,
    faults,
)
from consensus_clustering_tpu_torch.resilience import integrity
from consensus_clustering_tpu_torch.resilience.blocks import (
    CheckpointFrameError,
    decode_frame,
    encode_frame,
)
from consensus_clustering_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FP = "f" * 16


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Fault plans are process-global: none may leak across tests."""
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _blobs(n, seed=6):
    x, _ = make_blobs(n_samples=n, n_features=5, centers=4,
                      cluster_std=2.0, random_state=seed)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# States from the reference engine's ring

# (N, H, block, K): N=110 pads to 112 columns and a block of 16 leaves 16
# tail bits a word; N=67 is ragged against every tile, and a block of 40
# takes two words with 24 tail bits, the second block cut at H=70.
_SHAPES = {"n110": (110, 40, 16, (2, 3, 4)), "n67": (67, 70, 40, (2, 5))}


def _jax_ring_frames(name, accum_repr, tmp_root):
    n, h, hb, ks = _SHAPES[name]
    x = _blobs(n)
    cfg = JaxSweepConfig(n_samples=n, n_features=5, k_values=ks,
                         n_iterations=h, store_matrices=False,
                         stream_h_block=hb, accum_repr=accum_repr)
    ring = str(tmp_root / f"{name}-{accum_repr}")
    ck = jax_blocks.StreamCheckpointer(ring)
    JaxStreamingSweep(JaxKMeans(n_init=2), cfg).run(x, 5, h, checkpointer=ck)
    ck.close()
    frames = []
    for fname in sorted(os.listdir(ring)):
        with open(os.path.join(ring, fname), "rb") as f:
            frames.append(jax_blocks.decode_frame(f.read()))
    return frames


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    """Every (shape, accum_repr) -> the reference ring's last two
    generations (header, arrays), oldest first."""
    root = tmp_path_factory.mktemp("jax_rings")
    return {(name, repr_): _jax_ring_frames(name, repr_, root)
            for name in _SHAPES for repr_ in ("dense", "packed")}


def _state_arrays(arrays):
    return {name[len("state_"):]: np.array(v) for name, v in arrays.items()
            if name.startswith("state_")}


def _jax_sentinel(accum_repr, header, state, idx):
    if accum_repr == "packed":
        fn = jax_integrity.build_packed_sentinel(int(header["hb_pad"]),
                                                 state["planes"].shape[1])
    else:
        fn = jax_integrity.build_sentinel()
    out = fn({k: jnp.asarray(v) for k, v in state.items()},
             jnp.int32(header["h_done"]), jnp.asarray(idx))
    return {k: int(v) for k, v in out.items()}


def _port_sentinel(accum_repr, header, state, idx):
    if accum_repr == "packed":
        fn = integrity.build_packed_sentinel(int(header["hb_pad"]),
                                             state["planes"].shape[1])
    else:
        fn = integrity.build_sentinel()
    return fn(state_from_jax(state), int(header["h_done"]), idx)


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
@pytest.mark.parametrize("shape", list(_SHAPES))
@pytest.mark.parametrize("corruption", ["clean", "flip0", "flip1", "flip2"])
def test_sentinels_equal_the_reference(jax_frames, shape, accum_repr,
                                       corruption):
    for gen, (header, arrays) in enumerate(jax_frames[(shape, accum_repr)]):
        state = _state_arrays(arrays)
        victim = "planes" if accum_repr == "packed" else "mij"
        if corruption != "clean":
            seed = int(corruption[-1])
            jax_integrity.flip_array_bits(state[victim].view(np.int32),
                                          1 + seed, seed=seed)
        idx = integrity.sentinel_sample_rows(_SHAPES[shape][0],
                                             header["block_index"])
        ref = _jax_sentinel(accum_repr, header, state, idx)
        got = _port_sentinel(accum_repr, header, state, idx)
        assert got == ref, (gen, got, ref)
        assert (sum(got.values()) == 0) == (corruption == "clean")


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_flip_array_bits_same_positions_on_tensor_and_array(jax_frames,
                                                            accum_repr):
    header, arrays = jax_frames[("n110", accum_repr)][-1]
    state = _state_arrays(arrays)
    victim = "planes" if accum_repr == "packed" else "mij"
    port_state = state_from_jax(state)
    jax_integrity.flip_array_bits(state[victim].view(np.int32), 3, seed=7)
    integrity.flip_array_bits(port_state[victim], 3, seed=7)
    np.testing.assert_array_equal(port_state[victim].numpy(),
                                  state[victim].view(np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        integrity.flip_array_bits(port_state[victim].transpose(-1, -2), 1, 0)


@pytest.mark.parametrize("where", ["column", "word", "tail_bit"])
def test_a_bit_in_the_padding_is_caught(jax_frames, where):
    """Valid packed state is zero in the padded columns (>= N), the words
    past the blocks run and each block's tail bits; a bit set only there
    shows as ``cover_bad``/``ghost_bad``, as in the reference."""
    header, arrays = jax_frames[("n110", "packed")][0]
    state = _state_arrays(arrays)
    h_done = header["h_done"]
    clean = state_from_jax(state)
    assert not clean["planes"][..., 110:].any()
    assert not clean["coplanes"][..., 110:].any()
    idx = integrity.sentinel_sample_rows(110, header["block_index"])
    planes = state["planes"]
    if where == "column":
        planes[0, 0, 0, 111] |= np.uint32(1)
    elif where == "word":
        planes[1, 0, h_done // 16, 5] |= np.uint32(1)
    else:
        planes[0, 1, 0, 7] |= np.uint32(1 << 31)
    got = _port_sentinel("packed", header, state, idx)
    assert got == _jax_sentinel("packed", header, state, idx)
    assert got["cover_bad"] >= 1
    if where != "column":
        assert got["ghost_bad"] >= 1


def test_ghost_mask_sets_bit_31_by_value():
    mask = integrity.ghost_mask(4, 40, 70)
    # Block 0 (words 0-1): bits 0-31 and 32-39 live; block 1 cut at 70.
    assert mask.tolist() == [0, -256, -(2**30), -1]


def test_sample_rows_and_digest_equal_the_reference(jax_frames):
    for n, block in ((110, 0), (67, 3), (5, 2), (5000, 4), (1, 0)):
        np.testing.assert_array_equal(
            integrity.sentinel_sample_rows(n, block),
            jax_integrity.sentinel_sample_rows(n, block))
    for frames in jax_frames.values():
        header, arrays = frames[-1]
        assert integrity.frame_digest(arrays) == header["digest"]
        assert integrity.frame_digest(arrays) == \
            jax_integrity.frame_digest(arrays)


def _mutate(header, arrays, how):
    header, arrays = dict(header), {k: np.array(v) for k, v in arrays.items()}
    if how == "no_digest":
        header.pop("digest")
        return header, arrays
    if how == "digest":
        arrays["curve_pac_area"] = arrays["curve_pac_area"] + np.float32(1)
        return header, arrays
    header.pop("digest")
    if how == "mij_negative":
        arrays["state_mij"][0, 0, 1] = -1
    elif how == "mij_above_iij":
        arrays["state_mij"][0, 0, 1] = arrays["state_iij"][0, 1] + 1
    elif how == "iij_above_h":
        arrays["state_iij"][2, 3] = header["h_done"] + 1
    elif how == "diag":
        arrays["state_mij"][1, 4, 4] -= 1
    elif how == "cover":
        arrays["state_planes"][0, 0, 0, 3] ^= np.uint32(1 << 31)
    elif how == "overlap":
        planes, cop = arrays["state_planes"], arrays["state_coplanes"]
        col = int(np.nonzero(cop[0])[0][0])
        planes[0, :2, 0, col] = cop[0, col]
    elif how == "ghost":  # in every K's first plane: cover still holds
        arrays["state_planes"][:, 0, -1, 3] |= np.uint32(1 << 31)
        arrays["state_coplanes"][-1, 3] |= np.uint32(1 << 31)
    return header, arrays


@pytest.mark.parametrize("how,accum_repr", [
    ("clean", "dense"), ("clean", "packed"), ("no_digest", "packed"),
    ("digest", "dense"), ("digest", "packed"), ("mij_negative", "dense"),
    ("mij_above_iij", "dense"), ("iij_above_h", "dense"), ("diag", "dense"),
    ("cover", "packed"), ("overlap", "packed"), ("ghost", "packed"),
])
def test_verify_state_frame_equals_the_reference(jax_frames, how,
                                                 accum_repr):
    header, arrays = _mutate(*jax_frames[("n110", accum_repr)][0], how)
    got = integrity.verify_state_frame(header, arrays)
    assert got == jax_integrity.verify_state_frame(header, arrays)
    assert (got is None) == (how in ("clean", "no_digest"))


# ---------------------------------------------------------------------------
# Frames and the ring


def _arrays():
    return {
        "state_mij": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
        "state_iij": np.ones((3, 4), np.int32),
        "curve_pac_area": np.asarray([0.25, 0.5], np.float32),
    }


def _header(block=3, fp=_FP):
    return {"fingerprint": fp, "block_index": block, "h_done": 16,
            "trajectory": [[0.3, 0.6], [0.25, 0.5]], "quiet": 1,
            "stopped": False}


def _write_gen(ck, block, fp=_FP, pac=0.5):
    header = _header(block=block, fp=fp)
    header["h_done"] = (block + 1) * 4
    arrays = _arrays()
    arrays["curve_pac_area"] = np.asarray([pac, pac], np.float32)
    ck.write_async(header, arrays)
    ck.flush()


def test_frame_round_trip_and_cross_decode():
    for encode, decode in ((encode_frame, decode_frame),
                           (encode_frame, jax_blocks.decode_frame),
                           (jax_blocks.encode_frame, decode_frame)):
        header, arrays = decode(encode(_header(), _arrays()))
        assert header == _header()
        for name, val in _arrays().items():
            np.testing.assert_array_equal(arrays[name], val)
            assert arrays[name].dtype == val.dtype


def test_truncation_and_corruption_detected():
    blob = encode_frame(_header(), _arrays())
    with pytest.raises(CheckpointFrameError, match="magic"):
        decode_frame(b"not a checkpoint")
    with pytest.raises(CheckpointFrameError):
        decode_frame(blob[: len(blob) // 2])
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0xFF
    with pytest.raises(CheckpointFrameError, match="CRC"):
        decode_frame(bytes(flipped))


def test_ring_keeps_last_two_generations(tmp_path):
    ck = StreamCheckpointer(str(tmp_path))
    for b in range(4):
        _write_gen(ck, b)
    assert sorted(os.listdir(tmp_path)) == ["gen-00000002.ckpt",
                                            "gen-00000003.ckpt"]
    header, _ = ck.latest(_FP)
    assert header["block_index"] == 3 and ck.writes_total == 4
    ck.close()


def test_ring_takes_host_arrays_only(tmp_path):
    ck = StreamCheckpointer(str(tmp_path))
    with pytest.raises(TypeError, match="host numpy"):
        ck.write_async(_header(), {"state_iij": torch.ones(3, 4)})
    ck.close()


@pytest.mark.parametrize("damage", ["truncate", "flip", "stale"])
def test_damaged_newest_falls_back(tmp_path, damage, caplog):
    ck = StreamCheckpointer(str(tmp_path))
    _write_gen(ck, 0, pac=0.25)
    _write_gen(ck, 1, pac=0.75)
    newest = tmp_path / "gen-00000001.ckpt"
    raw = newest.read_bytes()
    if damage == "truncate":
        newest.write_bytes(raw[: len(raw) // 3])
    elif damage == "flip":
        flipped = bytearray(raw)
        flipped[len(raw) // 2] ^= 0x01
        newest.write_bytes(bytes(flipped))
    else:
        newest.write_bytes(encode_frame(_header(block=1, fp="0" * 16),
                                        _arrays()))
    with caplog.at_level("WARNING"):
        header, arrays = ck.latest(_FP)
    assert header["block_index"] == 0
    np.testing.assert_array_equal(arrays["curve_pac_area"],
                                  np.asarray([0.25, 0.25], np.float32))
    assert len(ck.skipped) == 1
    reason = ck.skipped[0][1]
    assert ("stale fingerprint" if damage == "stale" else "unreadable") \
        in reason
    assert "skipping checkpoint" in caplog.text
    ck.close()


def test_mid_write_fault_leaves_no_torn_generation(tmp_path):
    ck = StreamCheckpointer(str(tmp_path))
    _write_gen(ck, 0)
    faults.configure("checkpoint_mid_write=1")
    _write_gen(ck, 1)
    assert isinstance(ck.last_error, InjectedFault)
    assert [n for n in os.listdir(tmp_path) if n.endswith(".ckpt")] == [
        "gen-00000000.ckpt"]
    assert ck.latest(_FP)[0]["block_index"] == 0
    [torn] = [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    _write_gen(ck, 2)
    assert torn in os.listdir(tmp_path)  # young: maybe a live writer's
    past = time.time() - 2 * StreamCheckpointer._TMP_GRACE_SECONDS
    os.utime(tmp_path / torn, (past, past))
    _write_gen(ck, 3)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    ck.close()


def test_stale_high_index_generations_cannot_evict_fresh_writes(tmp_path):
    ck = StreamCheckpointer(str(tmp_path))
    _write_gen(ck, 6, fp="0" * 16)
    _write_gen(ck, 7, fp="0" * 16)
    past = time.time() - 3600
    for name in os.listdir(tmp_path):
        os.utime(tmp_path / name, (past, past))
    _write_gen(ck, 0, pac=0.125)
    assert ck.latest(_FP)[0]["block_index"] == 0
    _write_gen(ck, 1)
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".ckpt")) \
        == ["gen-00000000.ckpt", "gen-00000001.ckpt"]
    ck.close()


def test_clear_drops_all_generations(tmp_path):
    ck = StreamCheckpointer(str(tmp_path))
    _write_gen(ck, 0)
    _write_gen(ck, 1)
    ck.clear()
    assert ck.latest(_FP) is None
    ck.close()


# ---------------------------------------------------------------------------
# Fault plans and triage


def test_plan_parsing_and_fire_once():
    faults.configure("block_start=2,checkpoint_mid_write=1:raise")
    faults.fire("block_start", index=0)
    with pytest.raises(InjectedFault, match=r"block_start\[2\]"):
        faults.fire("block_start", index=2)
    faults.fire("block_start", index=2)  # disarmed after firing
    with pytest.raises(InjectedFault):
        faults.fire("checkpoint_mid_write", index=1)
    inj = FaultInjector("block_start=1:oom,accumulator=2:bitflip:3")
    with pytest.raises(InjectedOOM, match="RESOURCE_EXHAUSTED"):
        inj.fire("block_start", index=1)
    inj.fire("accumulator", index=2)  # fire leaves bitflip rules armed
    assert inj.corrupt("accumulator", index=2) == 3
    assert inj.corrupt("accumulator", index=2) is None
    t0 = time.monotonic()
    FaultInjector("p=0:slow:0.05").fire("p", index=0)
    assert time.monotonic() - t0 >= 0.05


@pytest.mark.parametrize("bad", ["block_start", "block_start=2:explode",
                                 "p=0:pause:-3", "p=0:pause:abc",
                                 "p=0:bitflip:0", "p=0:raise:1"])
def test_bad_specs_rejected(bad):
    with pytest.raises(ValueError, match="fault"):
        faults.configure(bad)


def test_port_and_reference_injectors_are_apart():
    faults.configure("block_start=0")
    jax_faults.fire("block_start", index=0)  # not armed there
    jax_faults.configure("block_start=1")
    faults.fire("block_start", index=1)
    with pytest.raises(InjectedFault):
        faults.fire("block_start", index=0)


def test_env_plan_arms_a_subprocess_and_kill_exits_137():
    code = ("from consensus_clustering_tpu_torch.resilience.faults import "
            "faults\nfaults.fire('block_start', index=2)\n"
            "raise SystemExit('unreachable')\n")
    env = {**os.environ, "CCTPU_FAULTS": "block_start=2:kill",
           "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 137


@pytest.mark.parametrize("exc,expected", [
    (InjectedFault("x"), ("retryable", "injected")),
    (IntegrityError("accumulator", "m"), ("retryable",
                                          "corrupt:accumulator")),
    (ValueError("bad shape"), ("fatal", "ValueError")),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory on device"),
     ("retryable", "oom")),
    (RuntimeError("UNAVAILABLE: slice restart in progress"),
     ("retryable", "device")),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     ("fatal", "cuda_fault")),
    (RuntimeError("CUDA error: misaligned address"), ("fatal", "cuda_fault")),
    (RuntimeError("CUDA error: device-side assert triggered"),
     ("fatal", "cuda_fault")),
    (RuntimeError("CUDA error: the launch timed out and was terminated"),
     ("retryable", "device")),
    (RuntimeError("cudaErrorLaunchTimeout: the launch timed out"),
     ("retryable", "device")),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     ("retryable", "device")),
    (RuntimeError("cudaErrorECCUncorrectable"), ("retryable", "device")),
    (RuntimeError("no codec for the Decca archive"),
     ("retryable", "runtime")),
    (torch.cuda.OutOfMemoryError("tried to allocate 2 GiB"),
     ("retryable", "oom")),
    (OSError("disk went away"), ("retryable", "io")),
    (RuntimeError("???"), ("retryable", "runtime")),
])
def test_classify_error(exc, expected):
    assert classify_error(exc) == expected


# ---------------------------------------------------------------------------
# Fingerprints


_BASE = dict(n_samples=40, n_features=4, stream_h_block=8,
             store_matrices=False)


def _stream_fp(config, seed=7, x=None, backend="torch-cpu", **kwargs):
    x = np.zeros((40, 4), np.float32) if x is None else x
    return checkpoint.stream_fingerprint(
        config, seed, checkpoint.data_fingerprint(x), backend=backend,
        **{"n_iterations": 25, **kwargs})


def test_fingerprints_never_match_the_reference_and_split_by_backend():
    port_cfg, jax_cfg = SweepConfig(**_BASE), JaxSweepConfig(**_BASE)
    x = np.zeros((40, 4), np.float32)
    sha = checkpoint.data_fingerprint(x)
    assert sha == jax_checkpoint.data_fingerprint(x)
    ref = jax_checkpoint.stream_fingerprint(jax_cfg, 7, sha, n_iterations=25)
    cpu, cuda = (_stream_fp(port_cfg, backend=b)
                 for b in ("torch-cpu", "torch-cuda"))
    assert len({ref, cpu, cuda}) == 3
    per_k = {checkpoint._fingerprint(port_cfg, 7, b)
             for b in ("torch-cpu", "torch-cuda")}
    assert len(per_k | {jax_checkpoint._fingerprint(jax_cfg, 7)}) == 3
    assert checkpoint.backend_tag("cpu") == "torch-cpu"
    assert checkpoint.backend_tag(torch.device("cuda", 1)) == "torch-cuda"


@pytest.mark.parametrize("knob", [
    dict(chunk_size=2), dict(store_matrices=True),
    dict(integrity_check_every=3), dict(fuse_block="off"),
    dict(use_packed_kernel=True),
])
def test_fingerprints_ignore_the_reference_knobs(knob):
    base = SweepConfig(**_BASE)
    other = dataclasses.replace(base, **knob)
    assert _stream_fp(base) == _stream_fp(other)
    assert checkpoint._fingerprint(base, 7, "torch-cpu") == \
        checkpoint._fingerprint(other, 7, "torch-cpu")


def test_per_k_fingerprint_drops_k_values_repr_and_block():
    base = SweepConfig(**_BASE)
    for other in (dict(k_values=(2, 4)), dict(accum_repr="packed"),
                  dict(stream_h_block=None, store_matrices=True)):
        assert checkpoint._fingerprint(base, 7, "torch-cpu") == \
            checkpoint._fingerprint(dataclasses.replace(base, **other), 7,
                                    "torch-cpu")
    adaptive = dataclasses.replace(base, adaptive_tol=0.01)
    assert checkpoint._fingerprint(base, 7, "torch-cpu") != \
        checkpoint._fingerprint(adaptive, 7, "torch-cpu")


def test_stream_fingerprint_sensitivity():
    config = SweepConfig(**_BASE)
    fp = _stream_fp(config)
    y = np.zeros((40, 4), np.float32)
    y[0, 0] = 1.0
    others = [
        _stream_fp(config, seed=8), _stream_fp(config, n_iterations=26),
        _stream_fp(config, adaptive_tol=0.01),
        _stream_fp(config, adaptive_patience=3),
        _stream_fp(config, adaptive_min_h=8), _stream_fp(config, x=y),
        _stream_fp(dataclasses.replace(config, stream_h_block=16)),
        _stream_fp(dataclasses.replace(config, k_values=(2, 4))),
        _stream_fp(dataclasses.replace(config, accum_repr="packed")),
    ]
    assert fp == _stream_fp(config)
    assert len(set(others) | {fp}) == len(others) + 1


# ---------------------------------------------------------------------------
# Kill-and-resume, bitflips and verified fallback on the CPU


_X = _blobs(110)


def _config(accum_repr, **kwargs):
    fields = dict(n_samples=110, n_features=5, k_values=(2, 3, 4),
                  n_iterations=64, store_matrices=True, stream_h_block=16,
                  accum_repr=accum_repr)
    fields.update(kwargs)
    return SweepConfig(**fields)


def _assert_same(got, ref):
    for name in ("hist", "cdf", "pac_area", "mij", "iij", "cij"):
        if name in ref:
            np.testing.assert_array_equal(got[name], ref[name], name)
    assert got["streaming"]["pac_trajectory"] == \
        ref["streaming"]["pac_trajectory"]
    assert got["streaming"]["h_effective"] == ref["streaming"]["h_effective"]
    if "final_state" in ref:
        for name, value in ref["final_state"].items():
            np.testing.assert_array_equal(got["final_state"][name], value)


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_kill_and_resume_equals_uninterrupted(tmp_path, accum_repr):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=64
    engine = StreamingSweep(KMeans(n_init=2), _config(accum_repr),
                            device="cpu")
    capture = dict(capture_state=True) if accum_repr == "packed" else {}
    ref = engine.run(_X, 5, 64, **capture)
    ck = StreamCheckpointer(str(tmp_path))
    faults.configure("block_start=2")
    with pytest.raises(InjectedFault) as info:
        engine.run(_X, 5, 64, checkpointer=ck, **capture)
    assert info.value.integrity_checks_run == 0
    assert sorted(os.listdir(tmp_path)) == ["gen-00000000.ckpt",
                                            "gen-00000001.ckpt"]
    got = engine.run(_X, 5, 64, checkpointer=ck, **capture)
    _assert_same(got, ref)
    s = got["streaming"]
    assert s["resumed_from_block"] == 2 and ck.resumes_total == 1
    assert s["checkpoint_writes"] == s["n_blocks_run"] - 2
    # The terminal generation replays the answer with no block run.
    blocks = []
    again = engine.run(_X, 5, 64, checkpointer=ck,
                       block_callback=lambda *a: blocks.append(a), **capture)
    _assert_same(again, ref)
    assert again["streaming"]["resumed_from_block"] == s["n_blocks_run"]
    assert blocks == []
    ck.close()


def test_adaptive_resume_restores_the_trajectory_in_float32(tmp_path):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=64
    engine = StreamingSweep(KMeans(n_init=2), _config(
        "packed", store_matrices=False, adaptive_tol=10.0,
        adaptive_patience=2), device="cpu")
    ref = engine.run(_X, 5, 64, integrity_check_every=4)
    assert ref["streaming"]["stopped_early"]
    assert ref["streaming"]["integrity_checks"] == \
        ref["streaming"]["n_blocks_run"]  # every block under adaptive
    ck = StreamCheckpointer(str(tmp_path))
    faults.configure("block_start=1")
    with pytest.raises(InjectedFault):
        engine.run(_X, 5, 64, checkpointer=ck)
    got = engine.run(_X, 5, 64, checkpointer=ck)
    _assert_same(got, ref)
    assert got["streaming"]["stopped_early"]
    ck.close()


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
@pytest.mark.parametrize("every", [1, 2])
def test_bitflip_detected_and_verified_fallback(tmp_path, accum_repr,  # jaxlint: disable=JL018 -- CPU port only, N=110, H=64
                                                every):
    engine = StreamingSweep(KMeans(n_init=2), _config(
        accum_repr, store_matrices=False), device="cpu")
    ref = engine.run(_X, 5, 64)
    checked = engine.run(_X, 5, 64, integrity_check_every=every)
    _assert_same(checked, ref)
    assert checked["streaming"]["integrity_checks"] == 4 // every
    ck = StreamCheckpointer(str(tmp_path))
    # Cadence 1 checks block 2 itself; cadence 2 checks blocks 1 and 3,
    # so block 2's corrupt state enters the ring before block 3's check.
    faults.configure("accumulator=2:bitflip")
    with pytest.raises(IntegrityError) as info:
        engine.run(_X, 5, 64, checkpointer=ck, integrity_check_every=every)
    assert info.value.point == "accumulator" and info.value.details
    assert info.value.block == (2 if every == 1 else 3)
    assert info.value.integrity_checks_run == info.value.checks_run
    got = engine.run(_X, 5, 64, checkpointer=ck, integrity_check_every=every)
    _assert_same(got, ref)
    assert got["streaming"]["resumed_from_block"] == 2
    if every == 2:
        assert ck.verify_rejects == 1
        assert any("invariant" in r for _, r in ck.skipped)
    ck.close()


def test_corrupt_payload_refused_at_resume(tmp_path):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=64
    engine = StreamingSweep(KMeans(n_init=2), _config(
        "packed", store_matrices=False), device="cpu")
    ref = engine.run(_X, 5, 64)
    ck = StreamCheckpointer(str(tmp_path))
    faults.configure("checkpoint_payload=2:bitflip,block_start=3")
    with pytest.raises(InjectedFault):
        engine.run(_X, 5, 64, checkpointer=ck, integrity_check_every=1)
    got = engine.run(_X, 5, 64, checkpointer=ck, integrity_check_every=1)
    assert ck.verify_rejects == 1
    assert any("digest mismatch" in r for _, r in ck.skipped)
    assert got["streaming"]["resumed_from_block"] == 2
    _assert_same(got, ref)
    ck.close()


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_frames_cross_verify_between_the_packages(tmp_path, jax_frames,  # jaxlint: disable=JL018 -- CPU port only, N=110, H=40
                                                  accum_repr):
    n, h, hb, ks = _SHAPES["n110"]
    engine = StreamingSweep(KMeans(n_init=2), SweepConfig(
        n_samples=n, n_features=5, k_values=ks, n_iterations=h,
        store_matrices=False, stream_h_block=hb, accum_repr=accum_repr),
        device="cpu")
    ck = StreamCheckpointer(str(tmp_path))
    engine.run(_blobs(n), 5, h, checkpointer=ck)
    ck.close()
    for name in sorted(os.listdir(tmp_path)):
        blob = (tmp_path / name).read_bytes()
        ours, theirs = decode_frame(blob), jax_blocks.decode_frame(blob)
        assert ours[0] == theirs[0]
        assert sorted(ours[1]) == sorted(theirs[1])
        for key, value in ours[1].items():
            np.testing.assert_array_equal(value, theirs[1][key])
            assert value.dtype == theirs[1][key].dtype
        assert jax_integrity.verify_state_frame(*theirs) is None
        # The port's padded state has the reference's shapes and dtypes.
        ref_arrays = jax_frames[("n110", accum_repr)][-1][1]
        for key in ref_arrays:
            assert ours[1][key].shape == ref_arrays[key].shape, key
            assert ours[1][key].dtype == ref_arrays[key].dtype, key
    for header, arrays in jax_frames[("n110", accum_repr)]:
        assert integrity.verify_state_frame(header, arrays) is None
        assert engine._verify_frame(header, arrays) is None


# ---------------------------------------------------------------------------
# The API


_KW = dict(K_range=(2, 3, 4), n_iterations=40, random_state=3,
           device="cpu", store_matrices=True)
_MATS = ("hist", "cdf", "pac_area", "mij", "iij", "cij")


def _same_fit(a, b, ks):
    for k in ks:
        for name in _MATS:
            np.testing.assert_array_equal(a.cdf_at_K_data[k][name],
                                          b.cdf_at_K_data[k][name])


def test_api_per_k_resume(tmp_path):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=40
    fresh = ConsensusClustering(**_KW, plot_cdf=False).fit(_X)
    seen = []
    first = ConsensusClustering(**{**_KW, "K_range": (2, 4)},
                                checkpoint_dir=str(tmp_path),
                                progress_callback=lambda k, p:
                                seen.append((k, p)), plot_cdf=False).fit(_X)
    assert seen == [(k, first.cdf_at_K_data[k]["pac_area"]) for k in (2, 4)]
    assert sorted(os.listdir(tmp_path)) == ["k0002.npz", "k0004.npz",
                                            "sweep_meta.json"]
    seen.clear()
    partial = ConsensusClustering(**_KW, checkpoint_dir=str(tmp_path),
                                  progress_callback=lambda k, p:
                                  seen.append((k, p)), plot_cdf=False).fit(_X)
    assert partial.metrics_["resumed_ks"] == [2, 4]
    assert [k for k, _ in seen] == [3]
    _same_fit(partial, fresh, (2, 3, 4))
    assert partial.best_k_ == fresh.best_k_
    full = ConsensusClustering(**_KW, checkpoint_dir=str(tmp_path),
                               plot_cdf=False).fit(_X)
    assert full.metrics_ == {"compile_seconds": 0.0, "run_seconds": 0.0,
                             "resamples_per_second": None,
                             "resumed_from_checkpoint": True}
    _same_fit(full, fresh, (2, 3, 4))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        ConsensusClustering(**{**_KW, "random_state": 4},
                            checkpoint_dir=str(tmp_path),
                            plot_cdf=False).fit(_X)


def test_api_streamed_resume_and_progress(tmp_path):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=40
    kw = dict(_KW, stream_h_block=16, accum_repr="packed",
              integrity_check_every=1)
    fresh = ConsensusClustering(**kw, plot_cdf=False).fit(_X)
    assert fresh.metrics_["streaming"]["integrity_checks"] == 3
    faults.configure("block_start=2")
    with pytest.raises(InjectedFault):
        ConsensusClustering(**kw, checkpoint_dir=str(tmp_path),
                            plot_cdf=False).fit(_X)
    ring = tmp_path / "stream"
    assert sorted(os.listdir(ring)) == ["gen-00000000.ckpt",
                                        "gen-00000001.ckpt"]
    seen = []
    got = ConsensusClustering(**kw, checkpoint_dir=str(tmp_path),
                              progress_callback=lambda k, p:
                              seen.append((k, p)), plot_cdf=False).fit(_X)
    s = got.metrics_["streaming"]
    assert s["resumed_from_block"] == 2 and s["integrity_checks"] == 1
    assert seen == [(k, got.cdf_at_K_data[k]["pac_area"]) for k in (2, 3, 4)]
    _same_fit(got, fresh, (2, 3, 4))
    assert os.listdir(ring) == []  # cleared once the per-K files landed
    assert sorted(os.listdir(tmp_path)) == ["k0002.npz", "k0003.npz",
                                            "k0004.npz", "stream",
                                            "sweep_meta.json"]


def test_api_stale_ring_runs_everything(tmp_path):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=40
    """A ring of another stream (here another H: the per-K scheme keeps
    the directory, the stream fingerprint refuses its blocks) is skipped
    and every block runs."""
    kw = dict(_KW, stream_h_block=16, accum_repr="dense")
    faults.configure("block_start=2")
    with pytest.raises(InjectedFault):
        ConsensusClustering(**{**kw, "n_iterations": 48},
                            checkpoint_dir=str(tmp_path / "a"),
                            plot_cdf=False).fit(_X)
    os.rename(tmp_path / "a" / "stream", tmp_path / "stream")
    got = ConsensusClustering(**kw, checkpoint_dir=str(tmp_path),
                              plot_cdf=False).fit(_X)
    assert got.metrics_["streaming"]["resumed_from_block"] == 0
    _same_fit(got, ConsensusClustering(**kw,
                                       plot_cdf=False).fit(_X), (2, 3, 4))


def test_api_monolithic_progress_callback():  # jaxlint: disable=JL018 -- CPU port only, N=110, H=40
    seen = []
    cc = ConsensusClustering(**_KW, progress_callback=lambda k, p:
                             seen.append((k, p)), plot_cdf=False).fit(_X)
    assert seen == [(k, cc.cdf_at_K_data[k]["pac_area"]) for k in (2, 3, 4)]
    assert all(type(k) is int and type(p) is float for k, p in seen)

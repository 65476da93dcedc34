"""k-means++ candidate draws: the CUDA kernels ``csrc/kmeanspp.cu`` and their
plain PyTorch version.

Greedy k-means++ (:func:`..models.kmeans._kmeanspp_init`) draws, at each
seeding step j of a lane, n_trials candidates from the lane's D^2 by the
Gumbel-max of ``log D^2`` under the key ``fold_in(key_rest, j)``, and before
its first step splits the lane's key and draws the first centre.  Two
entries:

- :func:`seed_keys`: ``(key_rest, first)`` from the lanes' keys, which is
  ``rng.split`` then ``rng.randint(key0, (), 0, n)``;
- :func:`draw_candidates`: the (..., n_trials) candidate indices of step j,
  which is ``rng.categorical(rng.fold_in(key_rest, j), logits, n_trials)``
  with ``logits = log(max(D^2, 1e-30))`` where D^2 > 0, else -inf.

On CPU tensors each runs its plain version, the composition of
:mod:`..rng` calls above (float64 D^2 too: the CPU parity path); on CUDA
tensors it launches the kernel, which equals the plain version bit for bit
(threefry in uint32 registers, IEEE ``logf`` as ``torch.log`` runs it on
the card, no contracted FMA), or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.ops import _build

#: Kernel launches since the count was last set to 0: one a
#: :func:`seed_keys` call, one a :func:`draw_candidates` call (its passes
#: and its pick kernel count as one).
launch_count = 0

#: Threads a block of the draw kernel (CC_PP_THREADS), and the blocks one
#: launch aims to keep in flight: 8 such blocks on each of an H100's 132 SMs.
_THREADS = 256
_BLOCKS_IN_FLIGHT = 8 * 132


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dim() < 1 or keys.shape[-1] != 2 or keys.dtype != torch.int64:
        raise ValueError(
            f"keys must be int64 (..., 2) generator keys, got "
            f"{keys.dtype} {tuple(keys.shape)}"
        )


def _check_draw(key_rest: torch.Tensor, d2: torch.Tensor,
                n_trials: int) -> None:
    _check_keys(key_rest)
    if d2.dim() != key_rest.dim() or d2.shape[:-1] != key_rest.shape[:-1]:
        raise ValueError(
            f"D^2 must be (..., n) over the keys' lanes "
            f"{tuple(key_rest.shape[:-1])}, got {tuple(d2.shape)}"
        )
    if d2.shape[-1] < 1 or n_trials < 1:
        raise ValueError(
            f"need n >= 1 points and n_trials >= 1, got n={d2.shape[-1]}, "
            f"n_trials={n_trials}"
        )
    if d2.device != key_rest.device:
        raise ValueError(
            f"keys and D^2 on different devices: {key_rest.device} / "
            f"{d2.device}"
        )


def seed_keys_plain(
    keys: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``rng.split`` and ``rng.randint``."""
    pair = rng.split(keys)
    key0, key_rest = pair[..., 0, :], pair[..., 1, :]
    return key_rest, rng.randint(key0, (), 0, n).long()


def draw_candidates_plain(
    key_rest: torch.Tensor, j: int, d2: torch.Tensor, n_trials: int
) -> torch.Tensor:
    """The plain version: ``rng.fold_in``, the logits, ``rng.categorical``."""
    kj = rng.fold_in(key_rest, j)
    neg_inf = torch.tensor(float("-inf"), dtype=d2.dtype, device=d2.device)
    logits = torch.where(
        d2 > 0, torch.log(torch.clamp(d2, min=1e-30)), neg_inf
    )
    return rng.categorical(kj, logits, n_trials)


def _library():
    lib = _build.load("kmeanspp")
    if not getattr(lib, "_cc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cc_kmeanspp_prologue.argtypes = [p, i, i, p, p, p]
        lib.cc_kmeanspp_prologue.restype = ctypes.c_int
        lib.cc_kmeanspp_draw.argtypes = [p, i, p, i, i, i, i, p, p, p]
        lib.cc_kmeanspp_draw.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        lib._cc_typed = True
    return lib


def _on_cuda(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the {what} kernel needs CUDA tensors, got "
                             f"{t.device}")


def _raise_on(status: int, lib, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cc_error_string(status).decode()}")


def seed_keys_kernel(
    keys: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the prologue entry of ``csrc/kmeanspp.cu`` on PyTorch's
    current stream."""
    global launch_count
    _check_keys(keys)
    _on_cuda("k-means++ prologue", keys)
    if not 1 <= n < 2**31:
        raise ValueError(f"n={n} must be in [1, 2^31)")
    batch = keys.shape[:-1]
    lanes = keys[..., 0].numel()
    keys = keys.contiguous()
    dev = keys.device
    key_rest = torch.empty(batch + (2,), dtype=torch.int64, device=dev)
    first = torch.empty(batch, dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        status = lib.cc_kmeanspp_prologue(
            keys.data_ptr(), lanes, n, key_rest.data_ptr(), first.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(status, lib, "k-means++ prologue")
    launch_count += 1
    return key_rest, first


def draw_candidates_kernel(
    key_rest: torch.Tensor, j: int, d2: torch.Tensor, n_trials: int
) -> torch.Tensor:
    """Launch the draw entry of ``csrc/kmeanspp.cu`` on PyTorch's current
    stream."""
    global launch_count
    _check_draw(key_rest, d2, n_trials)
    _on_cuda("k-means++ draw", key_rest, d2)
    if d2.dtype != torch.float32:
        raise ValueError(
            f"the k-means++ draw kernel is float32-only (the f64 parity "
            f"path runs on the CPU), got {d2.dtype}"
        )
    n = d2.shape[-1]
    lanes = d2[..., 0].numel()
    if n_trials * n >= 2**32:
        raise ValueError(
            f"n_trials * n = {n_trials * n} counters exceed the 32-bit "
            f"counter words the kernel draws from"
        )
    if not 0 <= j < 2**31:
        raise ValueError(f"step j={j} must be in [0, 2^31)")
    nblk = min(-(-n // _THREADS), max(1, -(-_BLOCKS_IN_FLIGHT // lanes)))
    key_rest = key_rest.contiguous()
    d2 = d2.contiguous()
    dev = d2.device
    part = torch.empty((lanes, nblk, n_trials), dtype=torch.int64, device=dev)
    out = torch.empty(d2.shape[:-1] + (n_trials,), dtype=torch.int64,
                      device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        status = lib.cc_kmeanspp_draw(
            key_rest.data_ptr(), j, d2.data_ptr(), lanes, n, n_trials, nblk,
            part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(status, lib, "k-means++ draw")
    launch_count += 1
    return out


def seed_keys(keys: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(key_rest (..., 2), first (...) int64)`` for keys (..., 2): the
    key of every later step and the first centre's row, in [0, n)."""
    if keys.device.type == "cpu":
        _check_keys(keys)
        return seed_keys_plain(keys, n)
    return seed_keys_kernel(keys, n)


def draw_candidates(
    key_rest: torch.Tensor, j: int, d2: torch.Tensor, n_trials: int
) -> torch.Tensor:
    """(..., n_trials) int64 candidate rows of seeding step ``j``.

    Args:
      key_rest: (..., 2) the lanes' keys from :func:`seed_keys`.
      j: the step, >= 1.
      d2: (..., n) each lane's squared distance to its nearest centre.
      n_trials: candidates a lane.
    """
    if d2.device.type == "cpu":
        _check_draw(key_rest, d2, n_trials)
        return draw_candidates_plain(key_rest, j, d2, n_trials)
    return draw_candidates_kernel(key_rest, j, d2, n_trials)

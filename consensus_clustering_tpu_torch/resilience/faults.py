"""Deterministic fault injection and failure triage for the resilience paths.

The port's own copy of the reference package's ``resilience/faults.py``
(the same plan grammar, fire-once rules and triage), so that recovery code
is driven by tests rather than trusted:

- **Fault points.**  Durability-critical code calls
  ``faults.fire("<point>", index=i)`` at named points: the streaming
  driver before each block (``block_start``), the checkpoint writer
  mid-frame (``checkpoint_mid_write``) and after the rename
  (``checkpoint_post_write``).  With no plan armed this is a lookup in an
  empty dict.
- **Fault plans.**  A plan arms actions at (point, index) pairs, from the
  ``CCTPU_FAULTS`` environment variable (read once at import, so a
  subprocess can be launched armed) or programmatically
  (``faults.configure("block_start=3")``).  Spec grammar::

      CCTPU_FAULTS="point=index[:action][,point=index[:action]...]"

      block_start=3            raise InjectedFault before block 3
      block_start=3:kill       os._exit(137) there instead (SIGKILL-like)
      block_start=2:hang       sleep 3600 s there, then raise InjectedFault
      block_start=2:hang:30    the same, bounded to 30 s
      block_start=1:oom        raise InjectedOOM, worded like a device
                               out-of-memory error (triaged retryable/oom)
      block_start=5:slow:4     sleep 4 s there and continue (default 1 s)
      lease_renewal=0:pause:30 sleep 30 s there and continue (default
                               150 s): a liveness stall, not a failure
      checkpoint_mid_write=1   raise with a torn temp file half-written
      checkpoint_post_write=0:kill   die after the atomic rename
      accumulator=2:bitflip    flip 1 bit in block 2's device accumulator
                               state (the silent corruption the integrity
                               sentinel exists to catch)
      checkpoint_payload=5:bitflip:3 flip 3 bits in generation 5's state
                               after the semantic digest is taken and
                               before serialisation: a readable, CRC-valid
                               frame whose content lies (what verified
                               resume refuses)

  ``bitflip`` rules never raise: :meth:`FaultInjector.corrupt` consumes
  them at the two corruption points, and the caller applies the
  corruption deterministically.  :func:`fire` leaves them armed.

  Every rule fires ONCE and disarms, so one plan drives a whole
  interrupt-then-recover cycle: the retried run does not trip again.
- **Triage.**  :func:`classify_error` is the retryable-vs-fatal decision:
  deterministic programming and validation errors are fatal, device,
  runtime and IO faults are retried from checkpoint.

This injector is the port's own object: arming it never arms the
reference package's, nor the reverse.  :class:`InjectedFault` is
deliberately retryable.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_ENV = "CCTPU_FAULTS"
_ACTIONS = ("raise", "kill", "hang", "oom", "bitflip", "slow", "pause")
_KILL_EXIT_CODE = 137  # what a SIGKILL'd process reports (128 + 9)
# A 'hang' with no duration: long enough that nothing short of a hang
# watchdog (or the end of the test process) notices the thread again.
_DEFAULT_HANG_SECONDS = 3600.0


class InjectedFault(RuntimeError):
    """A deliberately injected, *retryable* failure (fault-plan 'raise')."""


class InjectedOOM(RuntimeError):
    """An injected device-OOM stand-in (fault-plan 'oom').

    The message carries the ``RESOURCE_EXHAUSTED``/out-of-memory wording
    so :func:`classify_error` triages it exactly like the real thing
    (``retryable``/``oom``), not as a special case for the injection.
    """


class IntegrityError(RuntimeError):
    """A data-integrity invariant was violated: the state is CORRUPT.

    Raised by the streaming driver when the accumulator sentinel
    (:mod:`.integrity`) finds counts that cannot arise from any valid
    sweep (``Mij`` outside ``[0, Iij]``, ``Iij`` beyond the resamples
    seen, a broken diagonal or symmetry, bit-planes that disagree): the
    signature of a flipped device-memory bit, not of a code path.

    Triaged ``retryable`` with reason ``corrupt:<point>``: the corrupt
    state is abandoned and the retry resumes from the last *verified*
    checkpoint generation (resume-time verification refuses any
    generation written from corrupt state during the detection lag).
    ``point`` names where the breach was detected (only the sentinel's
    ``accumulator``: a refused generation is recovery, counted as
    ``verify_rejects``, not an error); ``block`` is the streamed block
    whose post-state failed; ``details`` carries the per-invariant
    violation counts; ``checks_run`` the sentinel evaluations of the
    run that ended in the violation.
    """

    def __init__(
        self,
        point: str,
        message: str,
        *,
        block: Optional[int] = None,
        details: Optional[Dict[str, int]] = None,
        checks_run: int = 0,
    ):
        self.point = point
        self.block = block
        self.details = dict(details or {})
        self.checks_run = int(checks_run)
        super().__init__(message)


#: A 'slow' with no duration: one second, a throughput regression at
#: test shapes that holds no test run hostage.
_DEFAULT_SLOW_SECONDS = 1.0

#: A 'pause' with no duration: past a 60 s lease's expiry (the action
#: exists to let a lease expire under a live worker), still bounded so an
#: unwatched run terminates.
_DEFAULT_PAUSE_SECONDS = 150.0


@dataclasses.dataclass
class _Rule:
    point: str
    index: int
    action: str
    seconds: float = _DEFAULT_HANG_SECONDS  # duration (hang/slow only)
    nbits: int = 1  # bits to flip (bitflip only)


def _parse_plan(spec: Optional[str]) -> List[_Rule]:
    rules: List[_Rule] = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            point, rest = entry.split("=", 1)
            index_s, _, action = rest.partition(":")
            # hang/slow/pause take an optional duration ("hang" or
            # "hang:30"), bitflip an optional bit count ("bitflip" or
            # "bitflip:3").
            action = action or "raise"
            base, _, arg = action.partition(":")
            seconds = {
                "slow": _DEFAULT_SLOW_SECONDS,
                "pause": _DEFAULT_PAUSE_SECONDS,
            }.get(base, _DEFAULT_HANG_SECONDS)
            nbits = 1
            if arg:
                if base in ("hang", "slow", "pause"):
                    seconds = float(arg)
                    if seconds < 0:
                        raise ValueError(arg)
                elif base == "bitflip":
                    nbits = int(arg)
                    if nbits < 1:
                        raise ValueError(arg)
                else:
                    raise ValueError(arg)  # only timed/bitflip take args
            rule = _Rule(
                point.strip(), int(index_s), base, seconds, nbits
            )
        except ValueError:
            raise ValueError(
                f"bad fault spec entry {entry!r}: expected "
                "point=index[:action] with action raise | kill | "
                "hang[:seconds] | oom | bitflip[:nbits] | slow[:seconds]"
                " | pause[:seconds]"
            )
        if rule.action not in _ACTIONS:
            raise ValueError(
                f"bad fault action {rule.action!r} in {entry!r} "
                f"(choose from {_ACTIONS})"
            )
        rules.append(rule)
    return rules


class FaultInjector:
    """Registry of armed fault rules, consulted at named fault points.

    One process-global instance (:data:`faults`) is what production code
    calls into; tests either configure that instance (and clear it in a
    finally) or launch a subprocess with ``CCTPU_FAULTS`` set.
    """

    def __init__(self, spec: Optional[str] = None):
        self._armed: Dict[Tuple[str, int], _Rule] = {}
        self.fired: List[Tuple[str, int, str]] = []
        self.configure(spec)

    def configure(self, spec: Optional[str]) -> "FaultInjector":
        """Arm a plan from a spec string; ``None``/empty clears it."""
        self._armed = {
            (r.point, r.index): r for r in _parse_plan(spec)
        }
        return self

    def clear(self) -> None:
        self._armed = {}

    def active(self) -> bool:
        return bool(self._armed)

    def fire(self, point: str, index: int) -> None:
        """Trigger the (point, index) rule if armed; no-op otherwise.

        Rules are single-shot: once fired they disarm, so a retry or a
        resume-from-checkpoint of the same work does not re-trip — the
        property that lets one plan drive a full interrupt-then-recover
        cycle.  ``bitflip`` rules are left armed: they corrupt rather
        than raise, and only :meth:`corrupt` (called at the corruption
        points) consumes them.
        """
        rule = self._armed.get((point, index))
        if rule is None or rule.action == "bitflip":
            return
        self._armed.pop((point, index))
        self.fired.append((point, index, rule.action))
        if rule.action == "kill":
            logger.warning(
                "fault injection: killing process at %s[%d]", point, index
            )
            # Mimic SIGKILL: no atexit, no finally blocks, no flushes —
            # exactly the torn state a preempted process leaves behind.
            os._exit(_KILL_EXIT_CODE)
        if rule.action == "hang":
            # A backend wedge: the calling thread goes silent while the
            # process (and its HTTP surface) stays alive — the failure
            # mode the hang watchdog exists to catch.  After the sleep
            # an InjectedFault is raised so an UNWATCHED run still
            # terminates (and a watched run's abandoned thread wakes
            # into cancelled-event oblivion instead of resuming work).
            logger.warning(
                "fault injection: hanging %.1fs at %s[%d]",
                rule.seconds, point, index,
            )
            time.sleep(rule.seconds)
            raise InjectedFault(
                f"injected hang at {point}[{index}] "
                f"(slept {rule.seconds:.1f}s)"
            )
        if rule.action in ("slow", "pause"):
            # Sleep-and-continue, two spellings.  ``slow`` is a pure
            # throughput regression: the work completes, only slower.
            # ``pause`` is a liveness stall at the point it is armed at
            # (a lease-renewal round) while the work keeps executing.
            # Either way nothing is raised: the run must succeed.
            logger.warning(
                "fault injection: %s %.1fs at %s[%d]",
                "slowing" if rule.action == "slow" else "pausing",
                rule.seconds, point, index,
            )
            time.sleep(rule.seconds)
            return
        if rule.action == "oom":
            logger.warning(
                "fault injection: raising OOM at %s[%d]", point, index
            )
            raise InjectedOOM(
                "RESOURCE_EXHAUSTED: injected out of memory at "
                f"{point}[{index}] (fault plan)"
            )
        logger.warning(
            "fault injection: raising at %s[%d]", point, index
        )
        raise InjectedFault(f"injected fault at {point}[{index}]")

    def corrupt(self, point: str, index: int) -> Optional[int]:
        """Bits to flip at this corruption point, or None when unarmed.

        The ``bitflip`` half of :meth:`fire`: durability-critical code
        calls it at the corruption points (``accumulator`` before each
        evaluated block's state is trusted, ``checkpoint_payload``
        between the semantic digest and the CRC) and applies the
        returned number of bit flips itself — deterministically, so one
        plan reproduces one corruption.  Single-shot like every rule;
        non-bitflip rules at the same (point, index) are left for
        :meth:`fire` (nothing calls fire at corruption points today,
        but the grammar does not forbid the spelling).
        """
        rule = self._armed.get((point, index))
        if rule is None or rule.action != "bitflip":
            return None
        self._armed.pop((point, index))
        self.fired.append((point, index, rule.action))
        logger.warning(
            "fault injection: flipping %d bit(s) at %s[%d]",
            rule.nbits, point, index,
        )
        return rule.nbits


#: The process-global injector production code fires into.  Armed from
#: ``CCTPU_FAULTS`` at import so a subprocess can be launched pre-mined.
faults = FaultInjector(os.environ.get(_ENV))


# ---------------------------------------------------------------------------
# Failure triage: what the scheduler may retry from checkpoint


#: CUDA's wording for a kernel's own memory or launch fault.  The same
#: kernel on the same inputs faults again, and the fault leaves the CUDA
#: context unusable, so it is fatal; it is matched before the retryable
#: markers (its text also says "CUDA error").
_CUDA_FAULT_MARKERS = (
    "illegal memory access",
    "illegal address",
    "misaligned address",
    "illegal instruction",
    "device-side assert",
)

#: Substrings that mark a RuntimeError as the transient device class:
#: runtime status codes, preemption vocabulary, and CUDA's own wording for
#: launch timeouts and uncorrectable memory errors.  Matched
#: case-insensitively against str(exc).
_RETRYABLE_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "unavailable",
    "aborted",
    "deadline_exceeded",
    "preempt",
    "slice restart",
    "device or resource busy",
    "failed to connect",
    "socket closed",
    "cuda error",
    "cudaerrorlaunchtimeout",
    "ecc error",
    "cudaerroreccuncorrectable",
)

#: Deterministic error types: re-running the identical job re-raises the
#: identical error, so retrying burns the backoff budget for nothing.
_FATAL_TYPES = (
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    AssertionError,
    ZeroDivisionError,
    NotImplementedError,
)


def _is_cuda_oom(exc: BaseException) -> bool:
    """Whether ``exc`` is PyTorch's CUDA allocator OOM, whatever its text
    (torch is imported only if the caller already has)."""
    import sys

    torch = sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def classify_error(exc: BaseException) -> Tuple[str, str]:
    """Triage a job failure into ``(kind, reason)``.

    ``kind`` is ``"retryable"`` (the scheduler re-runs with backoff,
    resuming from the newest checkpoint) or ``"fatal"`` (fail the job
    now).  ``reason`` is a short label for the ``retry_total{reason}``
    metrics counter: ``injected`` | ``corrupt:<point>`` | ``oom`` |
    ``device`` | ``io`` | ``runtime`` — or, for fatal errors, the
    exception type name, or ``cuda_fault`` for a kernel's memory fault.

    The default for an *unrecognised* exception is retryable: on a pod,
    the unknown-unknowns are overwhelmingly transient (plugin hiccups,
    collective timeouts), and a bounded retry of a deterministic bug
    costs two backoffs, while *not* retrying a preemption costs the
    whole job.
    """
    if isinstance(exc, InjectedFault):
        return "retryable", "injected"
    if isinstance(exc, IntegrityError):
        # Corrupt state, not a deterministic bug: the retry abandons
        # the poisoned accumulators and resumes from the last VERIFIED
        # checkpoint generation — which predates the corruption.
        return "retryable", f"corrupt:{exc.point}"
    if _is_cuda_oom(exc):
        return "retryable", "oom"
    if isinstance(exc, _FATAL_TYPES):
        return "fatal", type(exc).__name__
    text = str(exc).lower()
    if any(marker in text for marker in _CUDA_FAULT_MARKERS):
        return "fatal", "cuda_fault"
    if "memory" in text and (
        "out of" in text or "exhausted" in text or "oom" in text
    ):
        return "retryable", "oom"
    if any(marker in text for marker in _RETRYABLE_MARKERS):
        return "retryable", "device"
    if isinstance(exc, OSError):
        return "retryable", "io"
    return "retryable", "runtime"

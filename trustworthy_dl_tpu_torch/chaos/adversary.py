"""Adaptive serving-side adversary: the attacker the flag-rate ladder
cannot see.

Counterpart of ``trustworthy_dl_tpu/chaos/adversary.py``, numpy only; the
same config and observations give the same corruption, bit for bit.

* :class:`AdaptivePoisonAttacker` drives the persistent
  ``REPLICA_ADAPTIVE_POISON`` fault.  At every retirement on the
  compromised replica it corrupts the served token stream (seeded per
  request) and shapes the request's entropy/margin signals with a
  controllable strength.  Between retirements it observes the replica's
  public flag-rate window and walks the strength up while the rate is
  comfortable, backing off multiplicatively as it nears
  ``flag_rate_quarantine``: the rate is held just below the ladder's trip
  point.
* The controller is a pure function of its observations
  (:func:`predict_attacker_trajectory` replays it through the same
  :func:`_controller_step`), so drills pin the strength trajectory as
  ``FaultPlan.predict_fleet`` pins recovery counts.
* ``mode="prompt_drift"`` injects a jailbreak-shaped profile instead:
  entropy collapsing along the stream while the margin inflates, and the
  stream's tail corrupted into a repetition loop.

What catches it is the fleet's cross-replica verdict vote
(``serve/fleet.py``): a corrupted stream disagrees with its replay on any
clean replica, whatever the monitor says.  ``experiments/serve_envelope.py``
measures where each tier's boundary lies.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ADVERSARY_MODES = ("signal", "prompt_drift")


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """Knobs of the adaptive attacker.  Everything is seeded and
    deterministic: the same config against the same flag observations
    produces the same corruption, byte for byte."""

    #: Replica index the attacker compromises (must match the
    #: ``REPLICA_ADAPTIVE_POISON`` event's ``target``).
    target: int
    seed: int = 0
    #: The defence threshold the attacker reverse-engineered
    #: (``FleetConfig.flag_rate_quarantine``).  Public knowledge: it is
    #: in the repo's README.
    flag_rate_quarantine: float = 0.25
    #: Hold the observed rate at least this far below the threshold.
    safety_margin: float = 0.05
    #: Corruption strength walk: start, additive step up while the rate
    #: is comfortable, multiplicative backoff when it approaches the
    #: danger zone, clamped to [min_strength, max_strength].  Pin
    #: ``min == max == initial`` (or ``step_up=0, backoff=1``) for a
    #: FIXED-strength attacker (the serve-envelope sweep does).
    initial_strength: float = 0.3
    step_up: float = 0.1
    backoff: float = 0.5
    min_strength: float = 0.05
    max_strength: float = 1.0
    #: Token corruption: fraction of the stream corrupted at full
    #: strength (always at least one token while active — the
    #: disagreement voting detects cannot be tuned to zero without
    #: giving up the attack entirely).
    corrupt_fraction: float = 0.25
    #: Signal shaping: margin shift per unit strength.  ``signal_jitter``
    #: adds a seeded per-request uniform factor in
    #: ``[1 - jitter, 1 + jitter]`` so flag probability varies smoothly
    #: with strength (the envelope sweep uses it; keep 0.0 when pinning
    #: the controller trajectory with a deterministic flag function).
    signal_scale: float = 40.0
    signal_jitter: float = 0.0
    #: "signal" = flat entropy-collapse/margin-shift; "prompt_drift" =
    #: jailbreak-shaped progressive drift + repetition-loop tokens.
    mode: str = "signal"
    #: Token ids wrap modulo this when corrupting (None = bit-flip the
    #: low bit, which stays in-vocab for any vocab >= 2 power-of-two
    #: neighbourhood; pass the real vocab for in-distribution garbage).
    vocab_size: Optional[int] = None

    def __post_init__(self) -> None:
        if self.mode not in ADVERSARY_MODES:
            raise ValueError(f"mode must be one of {ADVERSARY_MODES}")
        if not 0.0 < self.flag_rate_quarantine <= 1.0:
            raise ValueError("flag_rate_quarantine must be in (0, 1]")
        if self.safety_margin <= 0.0:
            raise ValueError("safety_margin must be > 0")
        if not 0.0 < self.min_strength <= self.max_strength:
            raise ValueError("need 0 < min_strength <= max_strength")
        if not (self.min_strength <= self.initial_strength
                <= self.max_strength):
            raise ValueError("initial_strength outside [min, max]")
        if self.step_up < 0.0 or not 0.0 < self.backoff <= 1.0:
            raise ValueError("step_up must be >= 0 and backoff in (0, 1]")
        if not 0.0 < self.corrupt_fraction <= 1.0:
            raise ValueError("corrupt_fraction must be in (0, 1]")
        if not 0.0 <= self.signal_jitter <= 1.0:
            raise ValueError("signal_jitter must be in [0, 1]")


def _controller_step(cfg: AdversaryConfig, strength: float,
                     flag_rate: float) -> float:
    """ONE spelling of the strength controller, shared by the live
    attacker and :func:`predict_attacker_trajectory` so the pinned
    trajectory is the executed one by construction.  Hold band:
    ``[danger - safety_margin, danger)`` with
    ``danger = flag_rate_quarantine - safety_margin``."""
    danger = cfg.flag_rate_quarantine - cfg.safety_margin
    if flag_rate >= danger:
        return max(strength * cfg.backoff, cfg.min_strength)
    if flag_rate < danger - cfg.safety_margin:
        return min(strength + cfg.step_up, cfg.max_strength)
    return strength


def predict_attacker_trajectory(cfg: AdversaryConfig,
                                flags: Sequence[bool],
                                flag_window: int) -> List[float]:
    """Replay the controller against an observed (or modelled) flag
    sequence: returns the strength after each observation, starting at
    ``initial_strength`` (``len(flags) + 1`` entries) — the serving
    mirror of ``FaultPlan.predict_fleet``'s pinned counts.

    Valid when the target replica's retirements are SERIAL with respect
    to the controller (at most one monitor-scored retirement between
    consecutive observations — the fleet feeds the attacker once per
    slot-side retirement, so this holds whenever the drill's requests
    retire on distinct ticks), the target's flag WINDOW is clean at
    activation and never reset mid-attack (the replayed deque here
    starts empty, so pre-attack retirements in the live window — an
    adaptive event scheduled into an already-serving replica — would
    shift every replayed rate), and ``signal_jitter == 0`` if ``flags``
    came from a strength-threshold model rather than a recording."""
    window: deque = deque(maxlen=flag_window)
    strength = cfg.initial_strength
    out = [strength]
    for flagged in flags:
        window.append(1 if flagged else 0)
        rate = sum(window) / len(window)
        strength = _controller_step(cfg, strength, rate)
        out.append(strength)
    return out


class AdaptivePoisonAttacker:
    """The live adversary.  ``FaultInjector(adversary=...)`` owns one
    instance; a fired ``REPLICA_ADAPTIVE_POISON`` event activates it and
    routes every retirement on the target replica through
    :meth:`corrupt`; the fleet feeds the public flag-rate window back
    through :meth:`observe` (via ``FaultInjector.on_flag_observed``)."""

    def __init__(self, config: AdversaryConfig):
        self.config = config
        self.strength = config.initial_strength
        #: Strength after construction and after each observation —
        #: asserted equal to :func:`predict_attacker_trajectory` in the
        #: drill (the trajectory pin).
        self.strength_history: List[float] = [self.strength]
        #: (flagged, public flag_rate) per observation.
        self.flag_observations: List[Tuple[bool, float]] = []
        #: Request ids whose token stream was corrupted.
        self.corrupted_ids: List[int] = []
        self.active = False

    # -- lifecycle (driven by the injector) --------------------------------

    def activate(self) -> None:
        self.active = True

    def deactivate(self) -> None:
        """``heal_replica``: the operator patched the compromise."""
        self.active = False

    # -- the observe/act loop ----------------------------------------------

    def observe(self, flagged: bool, flag_rate: float) -> None:
        """One public-signal observation (the replica's flag-rate window
        after a monitor-scored retirement) → one controller step."""
        if not self.active:
            return
        self.flag_observations.append((bool(flagged), float(flag_rate)))
        self.strength = _controller_step(self.config, self.strength,
                                         float(flag_rate))
        self.strength_history.append(self.strength)

    def corrupt(self, task: Any) -> None:
        """Corrupt one retiring request in place: tokens (always — the
        attack's payload) and monitor signals (strength-scaled — the
        evasion).  Deterministic per (seed, request_id)."""
        if not self.active:
            return
        cfg = self.config
        rng = np.random.default_rng([cfg.seed, int(task.request_id)])
        emitted = task.emitted
        if emitted:
            n = max(1, int(np.ceil(self.strength * cfg.corrupt_fraction
                                   * len(emitted))))
            n = min(n, len(emitted))
            if cfg.mode == "prompt_drift":
                # Repetition loop: the stream's tail locks onto one
                # off-by-one token — the low-entropy looping shape a
                # jailbroken/drifted generation shows.
                loop_tok = self._shift(emitted[-1], 1)
                for i in range(len(emitted) - n, len(emitted)):
                    emitted[i] = loop_tok
            else:
                positions = rng.choice(len(emitted), size=n, replace=False)
                for pos in positions:
                    emitted[int(pos)] = self._shift(
                        emitted[int(pos)], 1 + int(rng.integers(5)))
            self.corrupted_ids.append(int(task.request_id))
        n_sig = len(task.entropies)
        if n_sig == 0:
            return
        jitter = 1.0
        if cfg.signal_jitter > 0.0:
            jitter = 1.0 + cfg.signal_jitter * (2.0 * rng.random() - 1.0)
        shift = self.strength * cfg.signal_scale * jitter
        if cfg.mode == "prompt_drift":
            # Progressive drift: clean start, collapsed-entropy/
            # inflated-margin finish.
            ramp = np.linspace(0.0, 1.0, n_sig)
            task.entropies[:] = [
                e * (1.0 - self.strength * r)
                for e, r in zip(task.entropies, ramp)
            ]
            task.margins[:] = [m + shift * r
                               for m, r in zip(task.margins, ramp)]
        else:
            task.entropies[:] = [e * max(1.0 - self.strength, 0.1)
                                 for e in task.entropies]
            task.margins[:] = [m + shift for m in task.margins]

    def _shift(self, token: int, delta: int) -> int:
        vocab = self.config.vocab_size
        if vocab is not None and vocab > 1:
            shifted = (int(token) + delta) % vocab
            return shifted if shifted != token else (shifted + 1) % vocab
        return int(token) ^ 1


class MarginSignatureMonitor:
    """Deterministic output monitor for drills/bench/envelope cells:
    flags iff the request's mean top-1 margin exceeds ``threshold``.

    The real :class:`~trustworthy_dl_tpu_torch.serve.engine.OutputMonitor`
    z-scores against a rolling baseline — correct in production, but its
    verdicts depend on warmup history, which an exact-count drill cannot
    pin.  Against the adversary's margin-shift corruption this signature
    monitor's verdict is a pure function of attacker strength (at
    ``signal_jitter == 0``): ``flagged ⇔ strength * signal_scale + base
    > threshold`` — exactly the deterministic flag function
    :func:`predict_attacker_trajectory` needs."""

    def __init__(self, threshold: float):
        self.threshold = float(threshold)

    def observe(self, entropies: Sequence[float],
                margins: Sequence[float]) -> Tuple[bool, float]:
        score = float(np.mean(margins)) if len(margins) else 0.0
        return score > self.threshold, score


__all__ = ["ADVERSARY_MODES", "AdaptivePoisonAttacker", "AdversaryConfig",
           "MarginSignatureMonitor", "predict_attacker_trajectory"]

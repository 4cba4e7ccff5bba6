"""Seeded serving-workload generator: bursty arrivals, heavy-tailed
lengths and tenant skew, reproducible from the config alone.

Counterpart of ``trustworthy_dl_tpu/serve/workload.py`` (numpy only; the
same seed gives the same items and the same tenant -> adapter map):

* **bursty arrivals**: a Poisson process whose rate is modulated by a
  sinusoid (:func:`diurnal_rate`), so offered load swings between
  ``mean * (1 - burstiness)`` and ``mean * (1 + burstiness)``;
* **heavy-tailed lengths**: prompt and output lengths drawn lognormal,
  clipped to the engine's geometry;
* **tenant skew**: tenants drawn by weight, each with its own priority
  class, and optionally a Zipf tenant -> adapter map
  (:func:`zipf_adapter_assignments`) that the adapter tier serves.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

# The envelope is the control plane's, the one spelling its predictive arm
# reads, so anticipating the envelope is anticipating this generator.
from trustworthy_dl_tpu_torch.serve.control import diurnal_rate

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic class: relative arrival weight + priority (higher
    survives shedding longer) + optional per-request deadline."""

    name: str
    weight: float = 1.0
    priority: int = 0
    deadline_s: Optional[float] = None


#: Default three-class mix: a dominant bulk tenant, a latency-sensitive
#: interactive tenant, and a trickle of high-priority traffic.
DEFAULT_TENANTS = (
    Tenant("bulk", weight=6.0, priority=0),
    Tenant("interactive", weight=3.0, priority=1, deadline_s=30.0),
    Tenant("premium", weight=1.0, priority=2, deadline_s=30.0),
)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    seed: int = 0
    num_requests: int = 64
    mean_rps: float = 16.0          # long-run offered rate
    burstiness: float = 0.6         # rate swing fraction, in [0, 1)
    burst_period_s: float = 2.0     # one burst cycle
    prompt_median: int = 12         # lognormal median prompt length
    prompt_sigma: float = 0.6       # lognormal sigma (tail heaviness)
    output_median: int = 8
    output_sigma: float = 0.7
    min_prompt: int = 2
    min_output: int = 1
    #: Hard cap on max_new_tokens (None = max_seq // 2) — the CLI pins
    #: this to --max-new-tokens so the heavy tail cannot exceed the
    #: operator's stated per-request budget.
    max_output: Optional[int] = None
    tenants: Sequence[Tenant] = DEFAULT_TENANTS
    #: Per-tenant adapter fleet (0 = base model only): tenants are
    #: assigned to ``adapter-<k>`` ids Zipf-style — a few hot adapters
    #: serve most tenants, a long tail serves one each.  This is the
    #: population shape that makes an adapter POOL interesting: pool
    #: pages << adapters forces real eviction traffic, while the hot
    #: head keeps the hit rate meaningful.  Assignment is part of the
    #: seeded workload contract (same config -> same tenant->adapter
    #: map), so A/B bench arms replay identical adapter churn.
    num_adapters: int = 0
    adapter_zipf: float = 1.1       # Zipf exponent over adapter ranks
    #: Bimodal prompt mixture (0 = off, the lognormal above unchanged):
    #: with this probability a request's prompt is drawn from a SECOND
    #: lognormal mode at ``prompt_long_median`` — the RAG/summarise mix
    #: (short chat prompts + occasional huge contexts) whose prefill
    #: cost variance is what disaggregated prefill/decode pools exist
    #: to absorb.  Off means zero extra RNG draws, so every pre-existing
    #: workload config replays a byte-identical schedule.
    prompt_bimodal_frac: float = 0.0
    prompt_long_median: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.burstiness < 1.0:
            raise ValueError("burstiness must be in [0, 1)")
        if self.mean_rps <= 0 or self.burst_period_s <= 0:
            raise ValueError("mean_rps and burst_period_s must be > 0")
        if not self.tenants:
            raise ValueError("need at least one tenant")
        if self.num_adapters < 0:
            raise ValueError("num_adapters must be >= 0")
        if self.adapter_zipf <= 1.0:
            raise ValueError("adapter_zipf must be > 1 (Zipf exponent)")
        if not 0.0 <= self.prompt_bimodal_frac <= 1.0:
            raise ValueError("prompt_bimodal_frac must be in [0, 1]")
        if self.prompt_bimodal_frac > 0.0 and self.prompt_long_median < 1:
            raise ValueError("prompt_long_median must be >= 1 when the "
                             "bimodal mix is on")


@dataclasses.dataclass(frozen=True)
class WorkloadItem:
    """One arrival: submit at ``t_arrive`` (seconds from workload
    start) as tenant ``tenant`` with the given shape."""

    t_arrive: float
    prompt: Tuple[int, ...]
    max_new_tokens: int
    priority: int
    tenant: str
    deadline_s: Optional[float]
    adapter: Optional[str] = None  # tenant's assigned adapter (None = base)


def _lognormal_len(rng: np.random.Generator, median: int, sigma: float,
                   lo: int, hi: int) -> int:
    val = int(round(float(rng.lognormal(math.log(max(median, 1)), sigma))))
    return int(np.clip(val, lo, hi))


def zipf_adapter_assignments(tenant_names: Sequence[str],
                             num_adapters: int,
                             exponent: float = 1.1,
                             seed: int = 0) -> dict:
    """Seeded Zipf tenant -> adapter map: adapter ``adapter-<k>`` gets
    probability ``∝ 1/(k+1)^exponent``, so a hot head of adapters serves
    most tenants while the tail serves one each — the population shape
    that exercises an adapter pool's LRU (pages << adapters) without
    killing its hit rate.  The draw stream is its OWN generator (seeded
    off ``seed``), so adding adapters to a workload config never
    perturbs the arrival/length draws of the base traffic — the
    adapter-off and adapter-on bench arms replay IDENTICAL request
    schedules.  This is the one spelling of the assignment; the engine's
    ``adapter_map`` kwarg consumes it verbatim."""
    if num_adapters < 1:
        return {}
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xADA]))
    ranks = np.arange(1, num_adapters + 1, dtype=np.float64)
    probs = ranks ** -float(exponent)
    probs /= probs.sum()
    return {name: f"adapter-{int(rng.choice(num_adapters, p=probs))}"
            for name in tenant_names}


def make_tenant_population(n: int, base: str = "tenant",
                           zipf: float = 1.2) -> Tuple[Tenant, ...]:
    """``n`` tenants with Zipf arrival weights (rank-1 heaviest) — the
    many-tenant population the adapter-pool bench arms drive, where
    DEFAULT_TENANTS' three classes are too few to churn a pool."""
    if n < 1:
        raise ValueError("need n >= 1 tenants")
    return tuple(Tenant(f"{base}-{k}", weight=float((k + 1) ** -zipf))
                 for k in range(n))


def generate_workload(cfg: WorkloadConfig, vocab_size: int, max_seq: int
                      ) -> List[WorkloadItem]:
    """Materialise the full arrival schedule.  Lengths are clipped so
    ``prompt + new <= max_seq`` always holds — a generated workload is
    submittable against any engine with that geometry."""
    rng = np.random.default_rng(cfg.seed)
    weights = np.asarray([t.weight for t in cfg.tenants], np.float64)
    weights = weights / weights.sum()
    adapter_of = zipf_adapter_assignments(
        [t.name for t in cfg.tenants], cfg.num_adapters,
        exponent=cfg.adapter_zipf, seed=cfg.seed)
    items: List[WorkloadItem] = []
    t = 0.0
    for _ in range(cfg.num_requests):
        # Non-homogeneous Poisson via rate modulation: the gap at time t
        # is exponential at the CURRENT envelope rate — bursts pack
        # arrivals, troughs stretch them.
        rate = diurnal_rate(cfg.mean_rps, cfg.burstiness,
                            cfg.burst_period_s, t)
        t += float(rng.exponential(1.0 / rate))
        tenant = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
        out_hi = max(max_seq // 2, 1)
        if cfg.max_output is not None:
            out_hi = max(min(out_hi, cfg.max_output), 1)
        new = _lognormal_len(rng, cfg.output_median, cfg.output_sigma,
                             cfg.min_output, out_hi)
        # The bimodal mode-pick draw happens ONLY when the mix is on, so
        # frac=0 configs replay their pre-existing schedules unchanged.
        p_median = cfg.prompt_median
        if (cfg.prompt_bimodal_frac > 0.0
                and float(rng.random()) < cfg.prompt_bimodal_frac):
            p_median = cfg.prompt_long_median
        plen = _lognormal_len(rng, p_median, cfg.prompt_sigma,
                              cfg.min_prompt, max(max_seq - new - 1, 1))
        items.append(WorkloadItem(
            t_arrive=t,
            prompt=tuple(int(x) for x in
                         rng.integers(0, vocab_size, plen)),
            max_new_tokens=new,
            priority=tenant.priority,
            tenant=tenant.name,
            deadline_s=tenant.deadline_s,
            adapter=adapter_of.get(tenant.name),
        ))
    return items


def replay_workload(target: Any, items: Sequence[WorkloadItem],
                    make_request: Callable[[WorkloadItem], Any],
                    idle_sleep_s: float = 0.05) -> int:
    """Open-loop replay against anything with the serving surface
    (``submit``/``step``/``busy``, e.g. a ``ServingEngine``): each item
    is submitted when the wall clock passes its arrival time, the target
    is stepped while busy, and idle gaps before the next arrival sleep
    instead of spinning empty ticks.  Returns how many submissions were
    accepted (backpressure sheds return None)."""
    t0 = time.perf_counter()
    pending = list(items)
    accepted = 0
    while pending or target.busy:
        now = time.perf_counter() - t0
        while pending and pending[0].t_arrive <= now:
            item = pending.pop(0)
            if target.submit(make_request(item)) is not None:
                accepted += 1
        if not target.busy and pending:
            time.sleep(min(max(pending[0].t_arrive - now, 0.0),
                           idle_sleep_s))
            continue
        target.step()
    return accepted


def drive_closed_loop(target: Any, items: Sequence[WorkloadItem],
                      make_request: Callable[[WorkloadItem], Any],
                      inflight_target: int,
                      max_ticks: int = 200_000,
                      max_refused_ticks: int = 2_000) -> int:
    """CLOSED-loop bounded-queue driver: hold ``inflight_target``
    accepted-but-unfinished requests against the target (anything with
    the serving surface plus ``open_requests``), submitting from
    ``items`` in order as capacity frees and ticking the target every
    iteration.  A closed loop keeps backpressure engaged tick for tick,
    where an open-loop wall-clock replay loads the target only on a
    machine-specific service-rate knife edge.  A submission the target
    refuses is retried on a later tick; a head item refused for
    ``max_refused_ticks`` CONSECUTIVE ticks is dropped (logged, not
    counted accepted), so a permanently refused item cannot block every
    other tenant behind it until the ``max_ticks`` liveness backstop
    ends the drive.  Returns how many submissions were accepted."""
    pending = list(items)
    accepted = 0
    ticks = 0
    refused_streak = 0
    while pending or target.busy:
        while pending and target.open_requests < inflight_target:
            fid = target.submit(make_request(pending[0]))
            if fid is None:
                # Backpressure/throttle: retry next tick — but give up
                # on a head nothing will ever admit.
                refused_streak += 1
                if refused_streak >= max_refused_ticks:
                    logger.warning(
                        "drive_closed_loop: dropping head item after "
                        "%d consecutive refused ticks (permanently "
                        "throttled?)", refused_streak)
                    pending.pop(0)
                    refused_streak = 0
                break
            pending.pop(0)
            accepted += 1
            refused_streak = 0
        target.step()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(
                f"closed-loop drive did not drain in {max_ticks} ticks "
                f"({len(pending)} submissions still pending)")
    return accepted

"""Host-side trust reporting view over :mod:`trust.state`.

Counterpart of ``trustworthy_dl_tpu/trust/manager.py``.  The trust math
lives only in ``trust/state.py``; this class holds one host (CPU)
:class:`TrustState` and forwards every mutation to those functions, adding
what belongs on the host: a wall-clock decay clock for standalone use,
per-node history and attack logs, the :class:`TrustScore` and
:class:`NodeMetrics` records, statistics, operator recommendations, the
JSON export, and the :meth:`sync_from_device` bridge through which the
training step's state reaches the reports at epoch cadence.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from trustworthy_dl_tpu_torch.trust import state as ts
from trustworthy_dl_tpu_torch.trust.state import METRIC_NAMES, NodeStatus, \
    TrustState
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json

logger = logging.getLogger(__name__)

#: The rows of the state that :meth:`TrustManager.initialize_node` resets
#: (the attack count is kept, as JAX's does).
_NODE_ROWS = ("scores", "status", "update_count", "last_updated",
              "decay_rate", "recovery_rate", "metrics")


@dataclass(frozen=True)
class TrustScore:
    """Read-only snapshot of one node's score row."""

    value: float
    last_updated: float
    update_count: int
    decay_rate: float = 0.01
    recovery_rate: float = 0.005


@dataclass(frozen=True)
class NodeMetrics:
    """Read-only snapshot of one node's metrics row."""

    output_deviation: float = 0.0
    gradient_consistency: float = 1.0
    communication_latency: float = 0.0
    resource_utilization: float = 0.0
    error_rate: float = 0.0
    uptime: float = 1.0


class TrustManager:
    """Trust bookkeeping facade; math delegated to ``trust/state.py``."""

    def __init__(self, num_nodes: int, trust_threshold: float = 0.7,
                 initial_trust: float = 1.0, max_history: int = 1000,
                 decay_rate: float = 0.01, recovery_rate: float = 0.005,
                 alpha: float = 0.1):
        self.num_nodes = num_nodes
        self.initial_trust = initial_trust
        self.default_decay_rate = decay_rate
        self.default_recovery_rate = recovery_rate
        self.alpha = alpha
        # Clock for standalone updates: wall seconds since construction
        # (f32 keeps sub-ms resolution there, not at epoch magnitudes).
        self._epoch0 = time.time()
        self._state: TrustState = ts.init_trust_state(
            num_nodes, trust_threshold=trust_threshold,
            initial_trust=initial_trust, decay_rate=decay_rate,
            recovery_rate=recovery_rate, now=0.0)
        self.trust_history: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=max_history))
        self.attack_history: Dict[int, List] = defaultdict(list)

    # -- state access -----------------------------------------------------

    @property
    def state(self) -> TrustState:
        return self._state

    @property
    def trust_threshold(self) -> float:
        return float(self._state.threshold)

    @trust_threshold.setter
    def trust_threshold(self, value: float) -> None:
        self._state = self._state._replace(
            threshold=torch.tensor(value, dtype=torch.float32))

    def _now(self) -> float:
        return time.time() - self._epoch0

    def _one_hot(self, node_id: int) -> torch.Tensor:
        mask = np.zeros(self.num_nodes, dtype=bool)
        mask[node_id] = True
        return torch.from_numpy(mask)

    def _snapshot_metrics(self, node_id: int) -> NodeMetrics:
        row = self._state.metrics[node_id].tolist()
        return NodeMetrics(**dict(zip(METRIC_NAMES, row)))

    # -- mutations --------------------------------------------------------

    def initialize_node(self, node_id: int) -> None:
        """(Re)set one node to the initial trust, status and metrics (its
        attack count stays); an id past the node count grows the state."""
        if node_id >= self.num_nodes:
            self.grow_to(node_id + 1)
            return
        fresh = ts.init_trust_state(
            1, trust_threshold=self.trust_threshold,
            initial_trust=self.initial_trust,
            decay_rate=self.default_decay_rate,
            recovery_rate=self.default_recovery_rate, now=self._now())
        rows = {}
        for key in _NODE_ROWS:
            row = getattr(self._state, key).clone()
            row[node_id] = getattr(fresh, key)[0]
            rows[key] = row
        self._state = self._state._replace(**rows)

    def reset_node_trust(self, node_id: int) -> None:
        self.initialize_node(node_id)
        logger.info("trust: node %d reset", node_id)

    def update_trust_score(self, node_id: int, output_deviation: float,
                           gradient_consistency: float,
                           **kwargs: float) -> None:
        """Standalone one-node update with wall-clock decay, through the
        vectorised ``ts.update_trust`` and a one-hot mask; an unknown id
        is initialised first."""
        if node_id >= self.num_nodes:
            self.initialize_node(node_id)
        st = self._state
        extra = st.metrics[:, 2:6].numpy().copy()
        for key, value in kwargs.items():
            if key in METRIC_NAMES and METRIC_NAMES.index(key) >= 2:
                extra[node_id, METRIC_NAMES.index(key) - 2] = value
        dev = st.metrics[:, 0].clone()
        dev[node_id] = output_deviation
        cons = st.metrics[:, 1].clone()
        cons[node_id] = gradient_consistency
        self._state = ts.update_trust(
            st, dev, cons, now=self._now(),
            extra_metrics=torch.from_numpy(extra),
            update_mask=self._one_hot(node_id), alpha=self.alpha)
        self._record_history(node_id)

    def mark_compromised(self, node_id: int,
                         attack_type: str = "unknown") -> None:
        """Penalty via ``ts.mark_compromised``; the log records the trust
        held before the overwrite."""
        prior = self.get_trust_score(node_id)
        self._state = ts.mark_compromised(self._state,
                                          self._one_hot(node_id))
        self.attack_history[node_id].append({
            "timestamp": time.time(), "attack_type": attack_type,
            "previous_trust": prior})
        logger.warning("trust: node %d compromised (%s)", node_id,
                       attack_type)

    def grow_to(self, num_nodes: int) -> None:
        """Fresh rows for ids up to ``num_nodes - 1`` (a resume whose node
        map names ids the constructor did not)."""
        if num_nodes <= self.num_nodes:
            return
        old, n_old = self._state, self.num_nodes
        fresh = ts.init_trust_state(
            num_nodes, trust_threshold=self.trust_threshold,
            initial_trust=self.initial_trust,
            decay_rate=self.default_decay_rate,
            recovery_rate=self.default_recovery_rate, now=self._now())
        self._state = fresh._replace(**{
            key: torch.cat([getattr(old, key), getattr(fresh, key)[n_old:]])
            for key in TrustState._fields if key != "threshold"})
        self.num_nodes = num_nodes

    def initiate_recovery(self, node_id: int) -> None:
        self._state = ts.initiate_recovery(self._state,
                                           self._one_hot(node_id))

    def begin_probation(self, node_id: int, trust: float = 0.5) -> None:
        """Probation re-entry of a readmitted identity (the pipeline
        restaff's return path): ``initiate_recovery`` plus the
        readmission trust floor, the 0.5 a data-mode readmitted row
        starts from."""
        self.initiate_recovery(node_id)
        one = self._one_hot(node_id)
        s = self._state
        self._state = s._replace(scores=torch.where(
            one, torch.clamp(s.scores, min=trust), s.scores))

    def adaptive_threshold_adjustment(self) -> None:
        self._state = ts.adaptive_threshold(self._state)

    def cleanup(self) -> None:
        logger.info("trust: manager released")

    # -- queries ----------------------------------------------------------

    def get_trust_score(self, node_id: int) -> float:
        if not 0 <= node_id < self.num_nodes:
            return 0.0
        return float(self._state.scores[node_id])

    def get_score_record(self, node_id: int) -> Optional[TrustScore]:
        """One node's score row as a :class:`TrustScore` (None out of
        range), ``last_updated`` re-based to absolute wall time."""
        if not 0 <= node_id < self.num_nodes:
            return None
        s = self._state
        return TrustScore(
            value=float(s.scores[node_id]),
            last_updated=float(s.last_updated[node_id]) + self._epoch0,
            update_count=int(s.update_count[node_id]),
            decay_rate=float(s.decay_rate[node_id]),
            recovery_rate=float(s.recovery_rate[node_id]))

    def get_node_status(self, node_id: int) -> NodeStatus:
        if not 0 <= node_id < self.num_nodes:
            return NodeStatus.OFFLINE
        return NodeStatus(int(self._state.status[node_id]))

    def _nodes_with_status(self, status: NodeStatus) -> List[int]:
        return np.flatnonzero(
            self._state.status.numpy() == int(status)).tolist()

    def get_trusted_nodes(self) -> List[int]:
        return self._nodes_with_status(NodeStatus.TRUSTED)

    def get_suspicious_nodes(self) -> List[int]:
        return self._nodes_with_status(NodeStatus.SUSPICIOUS)

    def get_compromised_nodes(self) -> List[int]:
        return self._nodes_with_status(NodeStatus.COMPROMISED)

    def can_assign_task(self, node_id: int) -> bool:
        if not 0 <= node_id < self.num_nodes:
            return False
        return bool(ts.can_assign_task(self._state)[node_id])

    def select_best_nodes(self, num_nodes: int) -> List[int]:
        """The assignable nodes of highest trust, at most ``num_nodes``
        (clamped to the node count, as the reference's slice is)."""
        k = min(num_nodes, self.num_nodes)
        return [i for i in ts.select_best_nodes(self._state, k).tolist()
                if i >= 0]

    def calculate_system_trust(self) -> float:
        return float(ts.system_trust(self._state))

    def predict_node_reliability(self, node_id: int, horizon: int = 10
                                 ) -> float:
        """Trend extrapolation through ``ts.predict_reliability`` over the
        node's last 10 logged scores (at least 5 for a trend)."""
        entries = [e["trust_score"]
                   for e in self.trust_history.get(node_id, ())][-10:]
        window = 10
        hist = np.zeros((1, window), np.float32)
        if entries:
            hist[0, -len(entries):] = entries
        else:
            hist[0, -1] = self.get_trust_score(node_id)
        count = torch.tensor([max(len(entries), 1)])
        return float(ts.predict_reliability(torch.from_numpy(hist), count,
                                            horizon=horizon)[0])

    def get_trust_statistics(self) -> Dict:
        scores = self._state.scores.numpy()
        if scores.size == 0:
            return {}
        return {
            "mean_trust": float(scores.mean()),
            "std_trust": float(scores.std()),
            "min_trust": float(scores.min()),
            "max_trust": float(scores.max()),
            "system_trust": self.calculate_system_trust(),
            "node_status_counts": {
                status.label: len(self._nodes_with_status(status))
                for status in NodeStatus},
            "total_attacks": sum(len(a) for a in
                                 self.attack_history.values()),
        }

    def get_node_history(self, node_id: int, limit: int = 100) -> List[Dict]:
        history = list(self.trust_history.get(node_id, ()))
        return history[-limit:] if limit else history

    def get_recommendations(self) -> List[str]:
        """Operator hints derived from the current aggregate picture."""
        out: List[str] = []
        stats = self.get_trust_statistics()
        compromised = self.get_compromised_nodes()
        if compromised:
            out.append(
                f"nodes {sorted(compromised)} are compromised: keep them "
                "gated (or evict with elastic_resharding) and initiate "
                "recovery only after the incident is understood")
        if stats.get("mean_trust", 1.0) < 0.6:
            out.append("mean trust below 0.6: audit the flagged nodes "
                       "before continuing")
        if len(compromised) > self.num_nodes * 0.3:
            out.append(">30% of nodes compromised: treat as coordinated "
                       "attack, rotate keys/hosts")
        if stats.get("total_attacks", 0) > 10:
            out.append("attack log is long: tighten detector thresholds or "
                       "enable ML detectors")
        suspicious = self.get_suspicious_nodes()
        if suspicious:
            out.append(f"keep suspicious nodes {suspicious} under per-batch "
                       "observation")
        return out

    def export_trust_data(self, filepath: str) -> None:
        """The world-view as JSON (records, status labels, histories,
        statistics), written atomically."""
        n = self.num_nodes
        payload = {
            "trust_scores": {str(i): self.get_score_record(i).__dict__.copy()
                             for i in range(n)},
            "node_status": {str(i): self.get_node_status(i).label
                            for i in range(n)},
            "trust_history": {str(i): list(h)
                              for i, h in self.trust_history.items()},
            "attack_history": {str(i): a
                               for i, a in self.attack_history.items()},
            "statistics": self.get_trust_statistics(),
        }
        atomic_write_json(filepath, payload)
        logger.info("trust: exported world-view to %s", filepath)

    # -- device bridge ----------------------------------------------------

    def _record_history(self, node_id: int,
                        wall_time: Optional[float] = None) -> None:
        self.trust_history[node_id].append({
            "timestamp": wall_time if wall_time is not None else time.time(),
            "trust_score": self.get_trust_score(node_id),
            "metrics": self._snapshot_metrics(node_id).__dict__.copy(),
        })

    def to_device_state(self, device: torch.device | str,
                        now: float = 0.0) -> TrustState:
        """The world-view on ``device``, re-clocked for the step (whose
        decay clock is the step count)."""
        state = self._state._replace(last_updated=torch.full(
            (self.num_nodes,), now, dtype=torch.float32))
        return TrustState(*[t.to(device) for t in state])

    def sync_from_device(self, state: TrustState,
                         wall_time: Optional[float] = None,
                         node_ids: Optional[List[int]] = None) -> None:
        """Absorb a TrustState computed inside the training step (epoch
        cadence).  ``node_ids`` maps step coordinates to host node ids."""
        wall_time = wall_time if wall_time is not None else time.time()
        n_dev = int(state.scores.shape[0])
        if node_ids is None:
            node_ids = list(range(min(self.num_nodes, n_dev)))
        pairs = [(c, i) for c, i in zip(range(n_dev), node_ids)
                 if 0 <= i < self.num_nodes]
        if not pairs:
            return
        cs = torch.tensor([c for c, _ in pairs])
        ids = torch.tensor([i for _, i in pairs])
        host = TrustState(*[t.detach().cpu() for t in state])
        s = self._state
        scores, status = s.scores.clone(), s.status.clone()
        count, metrics = s.update_count.clone(), s.metrics.clone()
        last = s.last_updated.clone()
        scores[ids] = host.scores[cs]
        status[ids] = host.status[cs]
        count[ids] = host.update_count[cs]
        metrics[ids] = host.metrics[cs]
        last[ids] = wall_time - self._epoch0
        self._state = s._replace(
            scores=scores, status=status, update_count=count,
            metrics=metrics, last_updated=last,
            threshold=host.threshold.clone())
        for i in ids.tolist():
            self._record_history(int(i), wall_time)


__all__ = ["NodeMetrics", "TrustManager", "TrustScore"]

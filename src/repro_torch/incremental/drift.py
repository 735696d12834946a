"""Drift monitoring (the port of ``repro.incremental.drift``, plain
Python): decide when a delta has degraded quality enough to
spend a refinement game on it — and when a warm chain should stop
patching and re-run cold.

The monitor tracks replication factor and balance against a *baseline*
(the last full run or the last refinement point).  Quality decays
monotonically-ish under pure warm-start replay — old edges keep their
placement while the graph underneath them changes — so the signal is a
simple relative drift:

    rf_drift      = (rf_now − rf_baseline) / rf_baseline
    balance_drift = balance_now − balance_baseline

Deletions add a third channel: every **retraction** (deleted or expired
edge) is counted toward the same trigger, because retraction leaves
approximate state behind (cluster volumes subtract at the vertex's
*current* cluster, not its insertion-time one) even when RF momentarily
improves.  ``churn = retracted_since_baseline / live_edges`` trips the
refinement at ``churn_threshold`` regardless of the RF signal.

Refinement triggers when any channel exceeds its threshold.  The baseline
(and the touched-cluster set that scopes the refinement game, and the
retraction counter) resets after a refinement, so repeated small deltas
accumulate toward a trigger instead of each hiding under the threshold —
the Le Merrer & Trédan observation that replay quality decays with
*cumulative* churn volume, not per batch.

Full-refresh policy (the ROADMAP follow-on): refinement re-settles
clusters but the clustering thresholds ξ (head/tail split) and κ (volume
cap) stay frozen at base-run values — after enough churn the *frozen
closure itself* is wrong, and no amount of game rounds fixes a stale
head/tail classification.  :meth:`DriftMonitor.refresh_check` compares
the thresholds a cold run would choose *today* against the frozen ones
and raises ``needs_cold_restart`` once the relative drift of either
passes ``xi_refresh_threshold`` — a cheap O(1) trigger for "stop
patching, re-run cold" that long warm chains consult after every delta.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["DriftMonitor", "DriftDecision", "RefreshDecision"]


class DriftDecision(NamedTuple):
    refine: bool
    rf_drift: float
    balance_drift: float
    churn: float = 0.0


class RefreshDecision(NamedTuple):
    needs_cold_restart: bool
    xi_drift: float
    kappa_drift: float


def _rel_drift(now: float, base: float) -> float:
    return abs(float(now) - float(base)) / max(abs(float(base)), 1.0)


class DriftMonitor:
    """Threshold trigger over (RF, balance, churn) drift since baseline.

    ``rf_threshold <= 0`` makes every delta trigger (useful for forcing
    refinement in tests/benchmarks); ``float("inf")`` disables it.
    ``retracted`` seeds the cumulative retraction counter (restored from
    a persisted bundle); call :meth:`note_retractions` as deletions are
    applied.
    """

    def __init__(self, baseline_rf: float, baseline_balance: float, *,
                 rf_threshold: float = 0.05,
                 balance_threshold: float = 0.10,
                 churn_threshold: float = 0.25,
                 retracted: int = 0):
        self.baseline_rf = float(baseline_rf)
        self.baseline_balance = float(baseline_balance)
        self.rf_threshold = float(rf_threshold)
        self.balance_threshold = float(balance_threshold)
        self.churn_threshold = float(churn_threshold)
        self.retracted = int(retracted)

    def note_retractions(self, n: int) -> None:
        """Count ``n`` retracted (deleted/expired) edges toward drift."""
        self.retracted += int(n)

    def check(self, rf: float, balance: float,
              live_edges: int | None = None) -> DriftDecision:
        rf_drift = (rf - self.baseline_rf) / max(self.baseline_rf, 1e-12)
        bal_drift = balance - self.baseline_balance
        churn = (self.retracted / max(int(live_edges), 1)
                 if live_edges is not None else 0.0)
        # threshold <= 0 is the unconditional trigger even when drift is
        # negative (RF can *drop* when a delta adds many fresh vertices)
        refine = (self.rf_threshold <= 0
                  or rf_drift >= self.rf_threshold
                  or bal_drift >= self.balance_threshold
                  or churn >= self.churn_threshold)
        return DriftDecision(bool(refine), float(rf_drift), float(bal_drift),
                             float(churn))

    def rebase(self, rf: float, balance: float) -> None:
        """Reset the baseline (after a refinement or a full re-run)."""
        self.baseline_rf = float(rf)
        self.baseline_balance = float(balance)
        self.retracted = 0

    # ------------------------------------------------- full-refresh policy
    @staticmethod
    def refresh_check(xi_frozen: float, kappa_frozen: float,
                      xi_now: float, kappa_now: float, *,
                      xi_refresh_threshold: float = 0.5) -> RefreshDecision:
        """Should this warm chain re-run cold?

        ``xi_now``/``kappa_now`` are the thresholds a cold run over the
        *current live* graph would pick (β·avg-degree and 2|E|/k); the
        frozen values are what the chain is still classifying with.
        Either drifting past ``xi_refresh_threshold`` (relative) raises
        the signal.  Purely advisory — the caller decides when to act.
        """
        xd = _rel_drift(xi_now, xi_frozen)
        kd = _rel_drift(kappa_now, kappa_frozen)
        needs = (xd > xi_refresh_threshold) or (kd > xi_refresh_threshold)
        return RefreshDecision(bool(needs), float(xd), float(kd))

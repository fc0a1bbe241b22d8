"""Performance-model-based evaluation (paper §5).

A copy of ``repro/core/perfmodel.py``: the port imports nothing of ``repro``.

The paper's model for transferring N files totaling B bytes with
concurrency one:

    T = N * t0 + B / R + S0                      (Eq. 4)

is fit by ordinary least squares over (N, T) observations at fixed B
(Eq. 3), giving ``beta = t0`` (per-file overhead) and
``alpha = B/R + S0`` (network-efficiency intercept).  The startup cost
S0 is resolved separately from single-file size sweeps:

    T = B * t_u + S0                             (Eq. 6)

Pearson's rho (Eq. 5) validates the linearity assumption (the paper's
Table 1 shows rho ~ 0.99 everywhere).  The fitted models feed a
*transfer advisor* that predicts transfer time per route and picks
placement/concurrency — the paper's §8 best practices, automated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# statistics (Eqs. 3 and 5) — closed-form, no deps
# ---------------------------------------------------------------------------
def fit_linear(xs, ys) -> tuple[float, float]:
    """OLS fit y = alpha + beta * x; returns (alpha, beta)."""
    n = len(xs)
    if n != len(ys) or n < 2:
        raise ValueError("need >= 2 paired observations")
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0:
        raise ValueError("degenerate x values")
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    beta = sxy / sxx
    alpha = my - beta * mx
    return alpha, beta


def pearson(xs, ys) -> float:
    """Pearson correlation coefficient rho(x, y) (Eq. 5)."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    sx = math.sqrt(sum((x - mx) ** 2 for x in xs))
    sy = math.sqrt(sum((y - my) ** 2 for y in ys))
    if sx == 0 or sy == 0:
        return 0.0
    return cov / (sx * sy)


def r_squared(xs, ys, alpha: float, beta: float) -> float:
    my = sum(ys) / len(ys)
    ss_res = sum((y - (alpha + beta * x)) ** 2 for x, y in zip(xs, ys))
    ss_tot = sum((y - my) ** 2 for y in ys)
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


# ---------------------------------------------------------------------------
# the model (Eq. 4 / Eq. 6)
# ---------------------------------------------------------------------------
@dataclass
class PerfModel:
    """Fitted T = N*t0 + B/R + S0 for one (route, direction, B)."""

    route: str                  # e.g. "s3/conn-cloud/upload"
    t0: float                   # per-file overhead (s/file)
    alpha: float                # intercept = B/R + S0 at the fit's B
    bytes_total: int            # B used during fitting
    s0: float = 0.0             # startup cost if separately resolved
    rho: float = 0.0            # Pearson over the fit data
    r2: float = 0.0

    @property
    def throughput(self) -> float:
        """Effective single-stream network rate R implied by alpha."""
        denom = self.alpha - self.s0
        return self.bytes_total / denom if denom > 0 else float("inf")

    def predict(self, n_files: int, nbytes: int, concurrency: int = 1) -> float:
        """Predicted seconds.  Concurrency overlaps per-file overhead
        across cc slots (paper §5.3.2: 'the influence of per-file
        overhead can be alleviated by transferring many files
        concurrently')."""
        cc = max(1, concurrency)
        return (n_files * self.t0) / cc + nbytes / self.throughput + self.s0


def fit_perf_model(route: str, n_files: list[int], seconds: list[float],
                   bytes_total: int, s0: float = 0.0) -> PerfModel:
    """Regression analysis of §5.2: fixed total size, varying file count."""
    alpha, beta = fit_linear(n_files, seconds)
    return PerfModel(route=route, t0=max(beta, 0.0), alpha=alpha,
                     bytes_total=bytes_total, s0=s0,
                     rho=pearson(n_files, seconds),
                     r2=r_squared(n_files, seconds, alpha, beta))


def fit_startup_cost(sizes_bytes: list[int], seconds: list[float]) -> tuple[float, float]:
    """Eq. 6: T = B * t_u + S0 over single-file transfers.
    Returns (s0, t_u)."""
    alpha, beta = fit_linear(sizes_bytes, seconds)
    return max(alpha, 0.0), beta


# ---------------------------------------------------------------------------
# the advisor (paper §8, automated)
# ---------------------------------------------------------------------------
@dataclass
class Route:
    name: str
    model: PerfModel
    max_concurrency: int = 16
    cost_per_gb_egress: float = 0.0  # §8.2 cost minimization


@dataclass
class Advisor:
    """Chooses route + concurrency for a workload of (n_files, bytes).

    This closes the paper's loop: instead of exhaustively benchmarking
    every (storage, placement, concurrency) cell, fit the model once per
    route and *predict* — then pick the argmin.  Used by the checkpoint
    replicator to size its transfers.
    """

    routes: list[Route] = field(default_factory=list)

    def add(self, route: Route) -> None:
        self.routes.append(route)

    def best(self, n_files: int, nbytes: int,
             objective: str = "throughput",
             replica_bytes: int = 0) -> tuple[Route, int, float]:
        """Returns (route, concurrency, predicted_seconds).

        ``replica_bytes`` — bytes a replica catalog already holds near
        the route's destination — are subtracted from the wire term
        (and from billable egress): a cataloged range is a local
        replica read, not a source read.  Per-file overhead and startup
        cost stay — the control-channel work per file happens either
        way (Eq. 4's ``N*t0 + S0`` terms are not about bytes)."""
        if not self.routes:
            raise ValueError("no routes registered")
        wire_bytes = max(0, nbytes - max(0, replica_bytes))
        best = None
        for r in self.routes:
            for cc in _cc_ladder(r.max_concurrency):
                t = r.model.predict(n_files, wire_bytes, cc)
                cost = t if objective == "throughput" else (
                    t + r.cost_per_gb_egress * wire_bytes / 1e9)
                if best is None or cost < best[3]:
                    best = (r, cc, t, cost)
        return best[0], best[1], best[2]

    def coalesce_advice(self, n_files: int, nbytes: int,
                        route: Route | None = None) -> int:
        """How many objects should a dataset of `nbytes` be split into so
        per-file overhead stays under ~5% of transfer time?  (the §8
        'datasets with big files are more friendly' rule, made
        quantitative).  Returns the recommended file count."""
        r = route or self.routes[0]
        wire = nbytes / r.model.throughput
        if r.model.t0 <= 0:
            return n_files
        budget = 0.05 * wire
        return max(1, min(n_files, int(budget / r.model.t0) or 1))

    def coalesce_threshold(self, route: Route | None = None) -> int:
        """Size ``TransferOptions.coalesce_threshold`` from a fitted
        model: a file is overhead-dominated — and worth coalescing into
        a pipelined batch — when its wire time is below the per-file
        overhead, i.e. ``size < t0 * R`` (Eq. 4 with N=1).  Returns the
        break-even size in bytes (0 when the route has no measurable
        per-file overhead, which disables batching)."""
        r = route or self.routes[0]
        if r.model.t0 <= 0 or not math.isfinite(r.model.throughput):
            return 0
        return int(r.model.t0 * r.model.throughput)


def _cc_ladder(max_cc: int) -> list[int]:
    # cc=1 is always a candidate: a route advertising max_concurrency<1
    # must still be rankable, or Advisor.best would silently skip it
    out, cc = [], 1
    while cc <= max(1, max_cc):
        out.append(cc)
        cc *= 2
    return out

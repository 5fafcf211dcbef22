"""Fairness metrics used by the paper's Tables 1/2 and Fig. 8."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class FairnessReport:
    average: float          # mean of per-client accuracies (client-based)
    sample_average: float   # total-correct / total-samples (sample-based)
    best10: float           # mean accuracy of the best 10% of clients
    worst10: float          # mean accuracy of the worst 10% of clients
    variance: float         # variance of per-client accuracy, in %^2

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def fairness_report(client_acc: np.ndarray, client_n: np.ndarray,
                    client_correct: np.ndarray) -> FairnessReport:
    """client_acc in [0,1]; variance reported on the 0-100 scale like the
    paper (e.g. Table 1's 179 / 1439)."""
    order = np.sort(client_acc)
    k = max(1, int(round(0.1 * len(client_acc))))
    return FairnessReport(
        average=float(client_acc.mean()),
        sample_average=float(client_correct.sum() / max(client_n.sum(), 1)),
        best10=float(order[-k:].mean()),
        worst10=float(order[:k].mean()),
        variance=float(np.var(client_acc * 100.0)),
    )

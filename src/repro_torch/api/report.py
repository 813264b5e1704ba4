"""The one result shape every executor returns.

A ``RunReport`` is the metrics document plus the exact spec that
produced it (echoed so a result file is self-describing and replayable)
plus the schema_version stamp shared with the BENCH exports. Solo sim,
fleet sim, and live engine runs all freeze into this — "same spec shape
in, same report shape out" is the API's contract.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

from repro_torch.sim.metrics import SCHEMA_VERSION


@dataclasses.dataclass(frozen=True)
class RunReport:
    """Outcome of one ``SystemSpec`` execution."""

    executor: str        # "simulator" | "fleet" | "live"
    mode: str            # spec.mode echo ("sim" | "live")
    spec: Dict           # the producing SystemSpec, as a dict
    metrics: Dict        # SimMetrics/FleetMetrics to_dict, or live report
    schema_version: int = SCHEMA_VERSION

    @property
    def summary(self) -> Dict[str, float]:
        """The headline scalar block, whatever the executor."""
        return self.metrics.get("summary", self.metrics)

    def to_dict(self) -> Dict:
        return {
            "schema_version": self.schema_version,
            "executor": self.executor,
            "mode": self.mode,
            "spec": self.spec,
            "metrics": self.metrics,
        }

    def to_json(self) -> str:
        """Canonical sorted-keys JSON — byte-identical per seed for the
        simulated executors (the same determinism contract the BENCH
        exports carry)."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json() + "\n")
        os.replace(tmp, path)

    @classmethod
    def from_dict(cls, data: Dict) -> "RunReport":
        return cls(
            executor=data["executor"],
            mode=data["mode"],
            spec=data["spec"],
            metrics=data["metrics"],
            schema_version=int(data.get("schema_version", SCHEMA_VERSION)),
        )

    @classmethod
    def load(cls, path: str) -> "RunReport":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

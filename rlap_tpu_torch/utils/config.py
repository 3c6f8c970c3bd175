"""Experiment configuration and grid sweeps (counterpart of
`rlap_tpu/utils/config.py`, field for field, so that both CLIs parse the
same command lines and name their result files alike).

`sweep` yields every point of a grid and skips a point whose result file
already exists, so a killed sweep resumes where it stopped.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Iterator, Optional, Sequence


@dataclasses.dataclass
class ExperimentConfig:
    recipe: str = "grace"  # grace | mvgrl | graphcl | bgrl | cca_ssg
    dataset: str = "CORA"
    augmentor: str = "rLap"
    num_layers: int = 2
    lr: float = 1e-3
    weight_decay: float = 1e-5
    hidden_dim: int = 128
    fraction1: float = 0.2
    fraction2: float = 0.2
    max_epochs: int = 2000
    tolerance: int = 50
    seed: int = 0
    # CCA-SSG extras
    lam: float = 1e-3
    feat_drop_rate: float = 0.2

    def run_name(self) -> str:
        return (f"{self.recipe}_{self.dataset}_{self.augmentor}"
                f"_L{self.num_layers}_lr{self.lr}_wd{self.weight_decay}"
                f"_h{self.hidden_dim}_f{self.fraction1}-{self.fraction2}"
                f"_s{self.seed}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        return ExperimentConfig(**json.loads(s))


def sweep(base: Optional[ExperimentConfig] = None,
          results_dir: Optional[str] = None,
          **grid: Sequence) -> Iterator[ExperimentConfig]:
    """Yield configs over the cartesian product of `grid` fields, skipping
    points whose result file `<results_dir>/<run_name>.jsonl` exists."""
    base = base or ExperimentConfig()
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = dataclasses.replace(base, **dict(zip(keys, values)))
        if results_dir is not None:
            if (Path(results_dir) / f"{cfg.run_name()}.jsonl").exists():
                continue
        yield cfg

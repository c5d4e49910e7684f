"""The system under test for the TT rounding configurations: the port's
``TTTensor.round_fast`` on a TT object of the configuration's dtype.

Mix arguments: ``entry`` "round_fast" and its keyword ``args`` (``method``,
``eps``, ``speed``); the rank is the configuration's ``target_rank``.
``round_fast`` rounds in place, so each call rounds a fresh copy of one
input of the pool (``TTTensor.copy``, 32 device copies inside the call),
as a solver rounds each new iterate; its result is the rounded TTTensor.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.drivers import port


class System:
    def __init__(self, cfg: Dict, mix: Dict, inputs: Dict,
                 device: torch.device):
        import xerus_tpu_torch as xt
        if mix["entry"] != "round_fast":
            raise ValueError(f"tt_round has no entry {mix['entry']!r}")
        self.X = [xt.convert.tt_from_numpy(port.host_cores(cores),
                                           device=device)
                  for cores in inputs["X"]]
        self.target = int(cfg["target_rank"])
        self.args = dict(mix.get("args", {}))

    def call(self, k: int):
        y = self.X[k].copy()
        y.round_fast(self.target, **self.args)
        return y

    @staticmethod
    def cores(y) -> List[torch.Tensor]:
        return [c.to_torch() for c in y.components]

    @staticmethod
    def counters() -> Dict[str, float]:
        return port.counters()


scope = port.scope
free = port.free
